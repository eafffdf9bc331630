"""One band of the banded sender (``parallel/sharded_jpeg.py``
``ShardedJpegEncoder``): its worker's K1 on its own card and stream, the
slots down into pinned memory and the band's C assembly, the program's
``compress.band`` span (``compress.k1``, ``compress.download`` and
``compress.assemble`` inside it), mean ms a band in the window; the bands
of a frame run at once on their workers.  None at a program that does not
split frames."""

from ugbench import readings

read = readings.zone_mean_ms("sender", "compress.band")
