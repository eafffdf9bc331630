"""Zone profiler (Tracy-equivalent aux subsystem): the port's own spans.

The port's version of ``ultragrid_tpu/utils/profiler.py`` (jax-free).

Parity with the reference's optional tracing (ref:
src/utils/profile_timer.hpp:10-44 — PROFILE_FUNC/PROFILE_DETAIL compile to
Tracy zones or no-ops).  Here zones are off unless enabled with
``--param profile[=trace.json]`` (or :func:`enable`).  Off, :func:`zone`
returns one shared no-op context object and records nothing: the cost is
the call and its arguments.

On, every record is the tuple ``(name, tid, t0_ns, dur_ns)`` stamped on
``time.monotonic_ns()``, the clock a device trace is moved onto, with three
attributes: ``frame``, the RTP timestamp of the frame the work was for
(None where unknown), the key that ties a frame's spans together across
threads and processes; ``parent``, the name of the innermost zone open on
the thread when it started; ``args``, a dict or None.  A zone opened inside
another on the same thread takes its parent's frame unless given one.
:func:`interval` records a wait that is known only once it ends (a queue,
the playout buffer) from its start to now; :func:`instant` marks an event.

The dump is Chrome ``chrome://tracing`` / Perfetto JSON: the process's pid,
its threads' names, each record's frame and args in ``args``, and in
``otherData`` the offset ``time.time_ns() - time.monotonic_ns()`` read at
dump time, which lines the spans up with a trace on the wall clock.  The
default file is ``ugtpu_trace.<pid>.json`` in the working directory, so the
sender's and the receiver's processes write two files.

Usage::

    from ultragrid_tpu_torch.utils import profiler
    with profiler.zone("compress", frame=rtp_ts):
        ...
    profiler.interval("send.queue", t_ready_ns, frame=rtp_ts)
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Dict, List, Optional

from ultragrid_tpu_torch.utils.params import add_to_param, get_commandline_param, param_is_set

add_to_param(
    "profile",
    "enable zone profiling; value = output path for the Chrome-trace JSON "
    "(default ugtpu_trace.<pid>.json in the working directory), viewable in chrome://tracing / Perfetto",
)


class Record(tuple):
    """One span or instant: ``(name, tid, t0_ns, dur_ns)``, with ``frame``,
    ``parent``, ``args`` and ``instant`` as attributes."""

    frame: Optional[int] = None
    parent: Optional[str] = None
    args: Optional[dict] = None
    instant = False


enabled = False
_events: List[Record] = []
_lock = threading.Lock()
_path: Optional[str] = None
_threads: Dict[int, str] = {}  # native thread id -> thread name
_local = threading.local()  # .open: the zones open on this thread, innermost last


class _Off:
    """The shared no-op zone of the off path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def _open_zones() -> list:
    try:
        return _local.open
    except AttributeError:
        _local.open = []
        return _local.open


def _record(name: str, t0: int, dur: int, frame, args, instant: bool = False) -> None:
    zones = _open_zones()
    rec = Record((name, threading.get_native_id(), t0, dur))
    if zones:
        rec.parent = zones[-1].name
        if frame is None:
            frame = zones[-1].frame
    if frame is not None:
        rec.frame = frame
    if args:
        rec.args = args
    if instant:
        rec.instant = True
    with _lock:
        if rec[1] not in _threads:
            _threads[rec[1]] = threading.current_thread().name
        _events.append(rec)


class _Zone:
    __slots__ = ("name", "frame", "t0")

    def __init__(self, name: str, frame: Optional[int]):
        self.name = name
        self.frame = frame

    def __enter__(self):
        zones = _open_zones()
        if self.frame is None and zones:
            self.frame = zones[-1].frame
        zones.append(self)
        self.t0 = time.monotonic_ns()

    def __exit__(self, *exc) -> bool:
        dur = time.monotonic_ns() - self.t0
        _open_zones().pop()
        _record(self.name, self.t0, dur, self.frame, None)
        return False


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


def zone(name: str, frame: Optional[int] = None):
    """PROFILE_DETAIL-style scoped zone, for the frame whose RTP timestamp
    is ``frame`` (default: the enclosing zone's)."""
    if not enabled:
        return _OFF
    return _Zone(name, frame)


def current_frame() -> Optional[int]:
    """The frame of the innermost zone open on this thread (None where none
    is, or tracing is off): what a worker thread's zones are given, since
    they open no zone of the caller's."""
    if not enabled:
        return None
    zones = _open_zones()
    return zones[-1].frame if zones else None


def interval(name: str, t0_ns: int, frame: Optional[int] = None, args: Optional[dict] = None) -> None:
    """Record a finished interval from ``t0_ns`` (``time.monotonic_ns()``)
    to now."""
    if enabled:
        _record(name, t0_ns, max(0, time.monotonic_ns() - t0_ns), frame, args)


def instant(name: str, frame: Optional[int] = None, args: Optional[dict] = None) -> None:
    if enabled:
        _record(name, time.monotonic_ns(), 0, frame, args, instant=True)


def dump(path: Optional[str] = None) -> Optional[str]:
    """Write the Chrome-trace JSON; returns the path (None if nothing)."""
    if not _events:
        return None
    pid = os.getpid()
    out = path or _path or f"ugtpu_trace.{pid}.json"
    with _lock:
        evs = list(_events)
        threads = dict(_threads)
    offset = time.time_ns() - time.monotonic_ns()
    trace_events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid, "args": {"name": tname}}
                    for tid, tname in threads.items()]
    for rec in evs:
        name, tid, t0, dur = rec
        ev = {"name": name, "ph": "i" if rec.instant else "X", "ts": t0 / 1000.0, "pid": pid, "tid": tid,
              "cat": "ugtpu"}
        if rec.instant:
            ev["s"] = "t"
        else:
            ev["dur"] = dur / 1000.0
        args = dict(rec.args or {})
        if rec.frame is not None:
            args["frame"] = rec.frame
        if args:
            ev["args"] = args
        trace_events.append(ev)
    trace = {"traceEvents": trace_events, "displayTimeUnit": "ms",
             "otherData": {"clock": "monotonic", "pid": pid, "wall_minus_monotonic_ns": offset}}
    with open(out, "w") as f:
        json.dump(trace, f)
    return out
