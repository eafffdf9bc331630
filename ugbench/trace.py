"""The traced run's readings: the device's operations from ``torch.profiler``
and the program's host spans, both on the host's monotonic clock.

Each process of a session traces itself.  The profiler stamps its events on
the wall clock, which every process on the host shares; they are moved to
``time.monotonic_ns()`` (the clock of the program's spans and of the
harness) by the offset between the two clocks read in that process.
"""

from __future__ import annotations

import gc
import time
from collections import defaultdict


class DeviceTracer:
    """``torch.profiler`` over the device's activity: kernels, copies and
    fills, as (name, start ns, duration ns) on the monotonic clock.  Keep a
    trace to a few seconds: a long one comes back without device events."""

    def __init__(self):
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self):
        """The device events recorded since :meth:`start`."""
        if self._prof is None:
            return []
        self._prof.__exit__(None, None, None)
        offset = time.time_ns() - time.monotonic_ns()
        out = []
        for e in self._prof.profiler.kineto_results.events():
            if not str(e.device_type()).endswith("CUDA"):
                continue
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns(), e.duration_ns()
            else:
                start, dur = e.start_us() * 1000, e.duration_us() * 1000
            out.append((e.name(), int(start) - offset, int(dur)))
        self._prof = None
        return out


class GcPauses:
    """The interpreter's garbage collections while on, as (start ns,
    duration ns, generation) on the monotonic clock: the diagnosis sets
    them beside the run's longest stalls."""

    def __init__(self):
        self.events = []
        self._t = None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.monotonic_ns()
        elif self._t is not None:
            self.events.append((self._t, time.monotonic_ns() - self._t, info["generation"]))
            self._t = None

    def start(self) -> None:
        gc.callbacks.append(self._callback)

    def stop(self):
        if self._callback in gc.callbacks:
            gc.callbacks.remove(self._callback)
        return self.events


def zones_start():
    """Turn on the program's own spans (``utils/profiler.py``)."""
    from ultragrid_tpu_torch.utils import profiler

    profiler.enable()


def zones_take():
    """The program's spans so far as (name, start ns, duration ns), and
    clear them (so the program writes no trace file at exit)."""
    from ultragrid_tpu_torch.utils import profiler

    with profiler._lock:
        evs = [(n, t0, dur) for n, _tid, t0, dur in profiler._events]
        profiler._events.clear()
    return evs


def union(intervals, lo: int, hi: int):
    """Merged [start, end) intervals clipped to [lo, hi), sorted."""
    spans = sorted((max(s, lo), min(s + d, hi)) for _n, s, d in intervals if s < hi and s + d > lo)
    merged = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(events, lo: int, hi: int) -> float:
    return sum(e - s for s, e in union(events, lo, hi)) / 1e9


def top_ops(events, lo: int, hi: int, n: int = 10):
    """[[name, seconds], ...]: the device operations that took most time."""
    tot = defaultdict(int)
    for name, s, d in events:
        if lo <= s < hi:
            tot[name] += d
    return [[k[:120], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(events, zones, lo: int, hi: int, n: int = 10):
    """[[what the host was doing, seconds], ...]: the device's idle gaps in
    [lo, hi), each under the shortest program span open at its midpoint
    ("no span" where none is), summed by span name."""
    import bisect

    busy = union(events, lo, hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    by_name = defaultdict(list)
    for name, s, d in zones:
        if d > 0:
            by_name[name].append((s, s + d))
    for v in by_name.values():
        v.sort()
    starts = {k: [s for s, _ in v] for k, v in by_name.items()}
    tot = defaultdict(int)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        best, best_len = "no span", None
        for name, ivs in by_name.items():
            i = bisect.bisect_right(starts[name], mid) - 1
            if i >= 0 and ivs[i][1] > mid and (best_len is None or ivs[i][1] - ivs[i][0] < best_len):
                best, best_len = name, ivs[i][1] - ivs[i][0]
        tot[best] += g1 - g0
    return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
