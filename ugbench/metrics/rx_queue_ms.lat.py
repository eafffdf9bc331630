"""The receiver's queues (``pipeline/receiver.py``): a frame's wait from the
start of its put to the next stage's ``get`` in the FEC thread's queue
(``fec.queue``) and in the decompress thread's (``decompress.queue``), mean
ms a frame in the window."""

from ugbench import spans

read = spans.frame_sum_ms("receiver", ("fec.queue", "decompress.queue"))
