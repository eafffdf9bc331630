"""The device's idle share of the window: no kernel, copy or fill of
either process of the session running."""

from ugbench import readings

read = readings.device_idle
