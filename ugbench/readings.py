"""What a traced run's per-layer metrics read (``metrics/<name>.py``).

A reader returns None where the run holds nothing for it; the harness then
leaves the metric out of the line.  ``run`` is :func:`ugbench.session.run_cell`'s
result with ``seconds`` added.
"""

from __future__ import annotations

from ugbench import registry, trace

NS = 1_000_000_000


def window(run):
    return run["t0_ns"], run["t0_ns"] + int(run["seconds"] * NS)


def latency_quantile_ms(run, q: float) -> float:
    """The ``q`` quantile of capture -> display over every frame of the
    window, a frame not shown counting until the run stopped waiting."""
    from ugbench.session import quantile

    return quantile([((run["shown"].get(key) or run["t_drain_end_ns"]) - stamp) / 1e6
                     for _, _, stamp, _, key in run["window"]], q)


def zone_mean_ms(proc: str, name: str):
    """A reader: the mean duration, in ms, of the program's ``name`` spans
    in ``proc`` ("sender" or "receiver") that start in the window."""

    def read(run):
        lo, hi = window(run)
        durs = [d for n, s, d in run["zones"][proc] if n == name and lo <= s < hi]
        return sum(durs) / len(durs) / 1e6 if durs else None

    return read


def device_slice(run):
    """The slice of the window in which both processes traced the device."""
    return run["device_slice"]


def kernel_time(run, proc: str, name: str):
    lo, hi = device_slice(run)
    durs = [d for n, s, d in run["kernels"][proc] if name in n and lo <= s < hi]
    return sum(durs) / NS, len(durs)


def k1_roofline(run):
    """K1's share of its roofline: the bound of the window's frames (their
    shape and coded bytes, ``rooflines/k1.py``) over the time of the
    sender's K1 launches in the window, in %."""
    if not run["device_slice"]:
        return None
    t, n = kernel_time(run, "sender", "jpeg_encode_kernel")
    if not n:
        return None
    k1 = registry.roofline("k1")
    w, h = run["frame_size"]
    lo, hi = device_slice(run)
    # the frames whose K1 launch the slice holds: one launch a frame, their
    # mean bound against the launches' mean time
    sizes = [run["sent"][key][2] for _, _, stamp, _, key in run["window"] if key in run["sent"]]
    bound = sum(k1.min_seconds(w, h, b) for b in sizes) / len(sizes)
    return 100.0 * bound / (t / n)


def k2_roofline(run):
    """K2's share of its roofline in the receiver's peel: each FEC job of
    the window with loss ran ``rounds`` launches over its symbols
    (``rooflines/k2.py``), over the time of the receiver's K2 launches in
    the window, in %."""
    if not run["device_slice"]:
        return None
    t, n = kernel_time(run, "receiver", "gf2_parity_kernel")
    if not n:
        return None
    k2 = registry.roofline("k2")
    lo, hi = device_slice(run)
    bound = sum(r * k2.peel_launch(ps, k, m, nnz)
                for ts, ps, k, m, nnz, r in run["child"]["peels"] if lo <= ts < hi)
    return 100.0 * bound / t


def merged_kernels(run):
    return run["kernels"]["sender"] + run["kernels"]["receiver"]


def merged_zones(run):
    return [(f"{proc}:{n}", s, d) for proc in ("sender", "receiver") for n, s, d in run["zones"][proc]]


def device_idle(run):
    """The share of the traced slice of the window in which no operation
    of either process ran on the device, in %."""
    events = merged_kernels(run)
    if not events or not run["device_slice"]:
        return None
    lo, hi = device_slice(run)
    return 100.0 * (1.0 - trace.busy_seconds(events, lo, hi) / ((hi - lo) / NS))
