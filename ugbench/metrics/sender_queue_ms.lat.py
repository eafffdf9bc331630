"""The sender's queues (``pipeline/sender.py``, ``modules/video_compress.py``
``CompressDriver``): a frame's wait from the capture thread's enqueue to the
compress worker's ``get`` (``compress.queue``) and from the end of its
compress to the send loop's ``pop`` (``send.queue``), mean ms a frame in
the window."""

from ugbench import spans

read = spans.frame_sum_ms("sender", ("compress.queue", "send.queue"))
