"""Receiver decode (``modules/video_decompress.py``: the C scan decode, the
upload, the reverse product): the program's ``rx.decompress`` span, mean
ms a frame in the window."""

from ugbench import readings

read = readings.zone_mean_ms("receiver", "rx.decompress")
