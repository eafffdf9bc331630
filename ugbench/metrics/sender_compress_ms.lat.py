"""Sender compress (``modules/video_compress.py``, ``ops/jpeg.py``: K1, the
slots' download, the C assembly): the program's ``compress`` span, mean ms
a frame in the window."""

from ugbench import readings

read = readings.zone_mean_ms("sender", "compress")
