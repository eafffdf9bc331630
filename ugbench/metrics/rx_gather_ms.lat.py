"""The banded receiver's gather (``parallel/sharded_jpeg.py``
``ShardedJpegDecoder.decode_frame``): the bands' rows copied onto the
display's card, the program's ``decompress.gather`` span inside
``rx.decompress``, mean ms a frame in the window (the copies' completion
falls in ``decompress.wait``).  None at a program that does not split
frames."""

from ugbench import readings

read = readings.zone_mean_ms("receiver", "decompress.gather")
