"""Reassembly and playout (``net/vrx_fast.py``, ``net/pbuf.py``): a frame's
wait in the playout buffer from its first datagram's arrival to its
release (``rx.playout``), mean ms a frame in the window."""

from ugbench import readings

read = readings.zone_mean_ms("receiver", "rx.playout")
