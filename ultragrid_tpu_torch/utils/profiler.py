"""Lightweight zone profiler (Tracy-equivalent aux subsystem).

The port's copy of ``ultragrid_tpu/utils/profiler.py`` (jax-free); the
trace is written to the working directory unless a path is given.

Parity with the reference's optional tracing (ref:
src/utils/profile_timer.hpp:10-44 — PROFILE_FUNC/PROFILE_DETAIL compile to
Tracy zones or no-ops).  Here zones are no-ops unless enabled with
``--param profile[=trace.json]``; enabled zones record
(name, thread, t0, dur) and the dump is Chrome ``chrome://tracing`` /
Perfetto JSON, the open equivalent of a Tracy capture.

Usage::

    from ultragrid_tpu_torch.utils import profiler
    with profiler.zone("compress"):
        ...

Overhead when disabled is one attribute check; timers use
``time.perf_counter_ns``.
"""

from __future__ import annotations

import atexit
import json
import threading
import time
from contextlib import contextmanager
from typing import List, Optional, Tuple

from ultragrid_tpu_torch.utils.params import add_to_param, get_commandline_param, param_is_set

add_to_param(
    "profile",
    "enable zone profiling; value = output path for the Chrome-trace JSON "
    "(default ugtpu_trace.json in the working directory), viewable in chrome://tracing / Perfetto",
)

enabled = False
_events: List[Tuple[str, int, int, int]] = []  # name, tid, t0_ns, dur_ns
_lock = threading.Lock()
_path = "ugtpu_trace.json"


def enable(path: Optional[str] = None) -> None:
    global enabled, _path
    if path:
        _path = path
    if not enabled:
        enabled = True
        atexit.register(dump)


def maybe_enable_from_params() -> None:
    """Called once at CLI startup; honors --param profile[=path]."""
    if param_is_set("profile"):
        enable(get_commandline_param("profile") or None)


@contextmanager
def zone(name: str):
    """PROFILE_DETAIL-style scoped zone."""
    if not enabled:
        yield
        return
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        dur = time.perf_counter_ns() - t0
        with _lock:
            _events.append((name, threading.get_ident(), t0, dur))


def instant(name: str) -> None:
    if enabled:
        with _lock:
            _events.append((name, threading.get_ident(), time.perf_counter_ns(), 0))


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the Chrome-trace JSON; returns the path (None if nothing)."""
    if not _events:
        return None
    out = path or _path
    with _lock:
        evs = list(_events)
    trace = {
        "traceEvents": [
            {
                "name": n,
                "ph": "X" if dur else "i",
                "ts": t0 / 1000.0,
                "dur": dur / 1000.0,
                "pid": 1,
                "tid": tid % 100000,
                "cat": "ugtpu",
            }
            for n, tid, t0, dur in evs
        ]
    }
    with open(out, "w") as f:
        json.dump(trace, f)
    return out
