"""The C assembly of the JPEG entropy stream (``ops/jpeg.py``
``JpegEncoder.assemble``, ``native/jpeg_assemble.c``): the program's
``compress.assemble`` span inside ``compress``, mean ms a frame in the
window."""

from ugbench import readings

read = readings.zone_mean_ms("sender", "compress.assemble")
