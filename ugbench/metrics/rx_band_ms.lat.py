"""One band of the banded receiver's decode (``parallel/sharded_jpeg.py``
``ShardedJpegDecoder``, run by ``modules/video_decompress.py``
``JpegDecompress`` over ``--param cuda-device``): the file up to the band's
card, the entropy decode of the band's restart segments and the reverse
product of its rows, enqueued without a wait, the program's
``decompress.band`` span inside ``rx.decompress``, mean ms a band in the
window.  None at a program that does not split frames."""

from ugbench import readings

read = readings.zone_mean_ms("receiver", "decompress.band")
