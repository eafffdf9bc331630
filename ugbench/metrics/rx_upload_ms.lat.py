"""The decoder's uploads of the scan decode's arrays to the device
(``ops/jpeg.py`` ``JpegDecoder``, pageable copies): the program's
``decompress.upload`` span inside ``rx.decompress``, mean ms a frame in the
window."""

from ugbench import readings

read = readings.zone_mean_ms("receiver", "decompress.upload")
