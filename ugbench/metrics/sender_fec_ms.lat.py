"""The sender's host LDGM encode (``net/transmit.py``, ``native/ldgm_xor.c``):
the program's ``tx.fec`` span inside ``fec+tx.send``, mean ms a frame in
the window."""

from ugbench import readings

read = readings.zone_mean_ms("sender", "tx.fec")
