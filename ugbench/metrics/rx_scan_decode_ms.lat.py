"""The C scan decode of the received JPEG (``native/jpeg_scan_decode.c``
through ``ops/jpeg.py`` ``JpegDecoder``): the program's ``decompress.scan``
span inside ``rx.decompress``, mean ms a frame in the window."""

from ugbench import readings

read = readings.zone_mean_ms("receiver", "decompress.scan")
