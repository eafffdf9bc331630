"""Receiver FEC (``pipeline/receiver.py``, ``net/video_rx.py``: the peel,
``LdgmSession.decode_device``): the program's ``rx.fec`` span, mean ms a
frame in the window."""

from ugbench import readings

read = readings.zone_mean_ms("receiver", "rx.fec")
