"""Kernel K2's share of its roofline (``rooflines/k2.py``) in the
receiver's peel, from the device trace."""

from ugbench import readings

read = readings.k2_roofline
