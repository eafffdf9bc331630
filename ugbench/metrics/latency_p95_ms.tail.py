"""The session's tail: capture -> display at the 95th percentile over every
frame of the window (a frame not shown counts until the run stopped
waiting for it).  Its spread from run to run is too wide to hold under a
bound, so it stands here beside ``latency_p50_ms``."""

from ugbench import readings


def read(run):
    return readings.latency_quantile_ms(run, 0.95)
