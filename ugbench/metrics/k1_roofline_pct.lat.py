"""Kernel K1's share of its roofline (``rooflines/k1.py``) in the sender,
from the device trace."""

from ugbench import readings

read = readings.k1_roofline
