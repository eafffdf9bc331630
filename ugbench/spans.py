"""Readers of the program's finer spans (``ultragrid_tpu_torch/utils/profiler.py``):
sums of a frame's spans for the per-layer metrics, and the traced run's
frame path, each segment beside the window's capture -> display latency,
with the check that the spans and the device trace share a clock.

``run`` is :func:`ugbench.session.run_cell`'s result with ``seconds``
added.  A reader returns None where the run holds none of its spans (a
program that does not record them).
"""

from __future__ import annotations

import bisect
import statistics

from ugbench import readings

# the spans a frame passes on its way from capture to display, one after
# the other, as (process, span); the sender's pacing overlaps the playout
# buffer's wait, which starts at the frame's first datagram
FRAME_PATH = (("sender", "compress.queue"), ("sender", "compress"), ("sender", "send.queue"),
              ("sender", "tx.fec"), ("receiver", "rx.playout"), ("receiver", "fec.queue"),
              ("receiver", "rx.fec"), ("receiver", "decompress.queue"), ("receiver", "rx.decompress"),
              ("receiver", "rx.postprocess"), ("receiver", "rx.display"))


def frame_sum_ms(proc: str, names):
    """A reader: the mean ms a frame of the spans ``names`` in ``proc``,
    each of which a frame passes once (the sum of their means over the
    window), or None where any of them is missing."""
    readers = [readings.zone_mean_ms(proc, name) for name in names]

    def read(run):
        means = [r(run) for r in readers]
        return None if any(m is None for m in means) else sum(means)

    return read


def frame_path(run) -> dict:
    """Each segment of :data:`FRAME_PATH`: its mean ms a frame over the
    window (None where absent), their sum, the window's mean capture ->
    display latency and the remainder (latency less the sum)."""
    segments = {name: readings.zone_mean_ms(proc, name)(run) for proc, name in FRAME_PATH}
    lat = [((run["shown"].get(key) or run["t_drain_end_ns"]) - stamp) / 1e6
           for _, _, stamp, _, key in run["window"]]
    total = sum(v for v in segments.values() if v is not None)
    mean = statistics.fmean(lat) if lat else None
    return {"segments_ms": segments, "sum_ms": total, "latency_mean_ms": mean,
            "remainder_ms": None if mean is None else mean - total}


def clock_check(run, kernel: str = "jpeg_encode_kernel"):
    """The sender's ``kernel`` launches in the device slice against its
    ``compress.k1`` and ``compress`` spans: how many start after the start
    of the latest ``compress.k1`` span before them and before the end of the
    ``compress`` span that holds that one, and the gap from the span's start
    to the launch's (median and largest, in microseconds).  None without a
    device slice, launches or spans."""
    if not run.get("device_slice"):
        return None
    lo, hi = readings.device_slice(run)
    launches = sorted(s for n, s, _ in run["kernels"]["sender"] if kernel in n and lo <= s < hi)
    zones = run["zones"]["sender"]
    k1 = sorted(s for n, s, _ in zones if n == "compress.k1")
    outer = sorted((s, s + d) for n, s, d in zones if n == "compress")
    if not launches or not k1 or not outer:
        return None
    outer_starts = [s for s, _ in outer]
    inside, gaps = 0, []
    for t in launches:
        i = bisect.bisect_right(k1, t) - 1
        if i < 0:
            continue
        j = bisect.bisect_right(outer_starts, k1[i]) - 1
        if j >= 0 and outer[j][0] <= k1[i] < outer[j][1] and t < outer[j][1]:
            inside += 1
            gaps.append((t - k1[i]) / 1e3)
    return {"launches": len(launches), "inside": inside, "share": inside / len(launches),
            "gap_median_us": statistics.median(gaps) if gaps else None,
            "gap_max_us": max(gaps) if gaps else None}


def window_spans(run) -> dict:
    """Each process's spans that start in the window, by name: [count,
    mean ms]."""
    lo, hi = readings.window(run)
    out = {}
    for proc, zs in run["zones"].items():
        by = {}
        for name, s, d in zs:
            if lo <= s < hi:
                by.setdefault(name, []).append(d)
        out[proc] = {name: [len(ds), sum(ds) / len(ds) / 1e6] for name, ds in sorted(by.items())}
    return out
