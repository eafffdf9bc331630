"""The share of the traced slice of the window in which no card of the
cell ran an operation of either process (kernels, copies, fills), in %:
on four cards, the time in which all four were idle at once.  The device
trace keeps no card index with its events, so each card's own idle share
is not read here; it is at least this share."""

from ugbench import readings

read = readings.device_idle
