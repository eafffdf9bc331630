"""Sender FEC and transmit (``net/transmit.py``, the host C LDGM,
``native/udp_tx.c``): the program's ``fec+tx.send`` span, mean ms a frame
in the window."""

from ugbench import readings

read = readings.zone_mean_ms("sender", "fec+tx.send")
