"""Kernel K1's share of its roofline (``rooflines/k1.py``) in the banded
sender (``parallel/sharded_jpeg.py``), from the device trace: the sender's
K1 launches on every card in the traced slice, one a band, each against
the bound of one band: the frame's shape cut into as many row bands as the
sender recorded ``compress.band`` spans a ``compress`` span in the window,
and that share of each window frame's coded bytes, in %.  None where the
run has no device slice or no K1 launch, or its sender recorded no
``compress.band`` span (a program that encodes each frame in one launch)."""

from ugbench import readings, registry


def read(run):
    if not run["device_slice"]:
        return None
    lo, hi = readings.window(run)
    bands = sum(1 for n, s, _ in run["zones"]["sender"] if n == "compress.band" and lo <= s < hi)
    frames = sum(1 for n, s, _ in run["zones"]["sender"] if n == "compress" and lo <= s < hi)
    if not bands or not frames:
        return None
    nband = max(1, round(bands / frames))
    t, n = readings.kernel_time(run, "sender", "jpeg_encode_kernel")
    if not n:
        return None
    k1 = registry.roofline("k1")
    w, h = run["frame_size"]
    sizes = [run["sent"][key][2] for _, _, _, _, key in run["window"] if key in run["sent"]]
    if not sizes:
        return None
    bound = sum(k1.min_seconds(w, h // nband, b // nband) for b in sizes) / len(sizes)
    return 100.0 * bound / (t / n)
