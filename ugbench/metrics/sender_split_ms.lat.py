"""The banded sender's split (``parallel/sharded_jpeg.py``
``ShardedJpegEncoder.encode``, run by ``modules/video_compress.py``
``JpegCompress`` over ``--param cuda-device``): the frame's row bands copied
from the capture's card to theirs and waited for, the program's
``compress.split`` span inside ``compress``, mean ms a frame in the window.
None at a program that does not split frames."""

from ugbench import readings

read = readings.zone_mean_ms("sender", "compress.split")
