"""Own-H.264 decode throughput: the C stage (native/h264_entropy.c), per
entropy mode and content class.

The port of ``ultragrid_tpu/tools/bench_h264_decode.py``: the streams are
encoded with libx264 through ``modules/lavc.py::LavcCompress`` (ref
``tools/bench_h264_decode.py:45-58``) from frames on the card (or on
``--device cpu``), which the encoder reads once on the host; the decode it
times runs on the host, one core.  Needs libavcodec.

Usage: python -m ultragrid_tpu_torch.tools.bench_h264_decode [WxH] [frames] [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ultragrid_tpu_torch.modules.lavc import LavcCompress
from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder
from ultragrid_tpu_torch.tools._bench import device_arg
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.pattern import generate_pattern

CONFIGS = [
    ("cavlc", "codec=H.264:encoder=libx264:profile=baseline:qp=28:g=30:"
              "aq-mode=0:refs=3:x264opts=partitions=p8x8"),
    ("cabac", "codec=H.264:encoder=libx264:profile=main:qp=28:g=30:"
              "aq-mode=0:x264opts=bframes=0:weightp=0"),
    ("cabac-b3", "codec=H.264:encoder=libx264:profile=high:qp=28:g=30:"
                 "aq-mode=0:bf=3"),
]


def make_frames(w, h, n, kind, device="cuda"):
    """``n`` UYVY frames on ``device``: moving bars ("synthetic") or smoothed
    noise with a global pan ("textured", worst-case rates)."""
    rng = np.random.default_rng(1)
    host = []
    if kind == "synthetic":
        base = generate_pattern(w, h, Codec.UYVY, "bars", device="cpu").numpy()
        for i in range(n):
            f = np.roll(base, i * 8, axis=1).copy()
            f[h // 10:h // 3, w // 5:w] = np.roll(f[h // 10:h // 3, w // 5:w], i * 3, axis=0)
            host.append(f)
    else:
        tex = rng.integers(0, 256, (h + 64, 2 * (w + 64)), np.uint8)
        tex = ((tex[:-1].astype(np.int32) + tex[1:]) // 2).astype(np.uint8)
        host = [tex[i:i + h, 2 * i:2 * i + 2 * w].copy() for i in range(n)]
    return [VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [torch.from_numpy(f).to(device)]) for f in host]


def encode(frames, spec: str, device="cuda"):
    """The access units libx264 gives for ``frames`` under ``spec``."""
    enc = LavcCompress(spec, device=device)
    aus = []
    for f in frames:
        c = enc.compress(f)
        if c is not None:
            aus.append(bytes(np.asarray(c.data)))
    enc.done()
    return aus


def decode_rate(aus):
    """(frames/s, ms a frame) of the C decoder over ``aus``, after one warm
    decode of the first."""
    fd = FastStreamDecoder()
    fd.decode_au(aus[0])
    t0 = time.perf_counter()
    for au in aus:
        fd.decode_au(au)
    dt = time.perf_counter() - t0
    return len(aus) / dt, dt / len(aus) * 1e3


def main(argv=None) -> int:
    args, device = device_arg(sys.argv[1:] if argv is None else argv)
    size = args[0] if args else "1920x1080"
    n = int(args[1]) if len(args) > 1 else 30
    w, h = (int(x) for x in size.split("x"))
    for kind in ("synthetic", "textured"):
        frames = make_frames(w, h, n, kind, device)
        for name, spec in CONFIGS:
            aus = encode(frames, spec, device)
            mb = sum(len(a) for a in aus) / 1e6
            fps, ms = decode_rate(aus)
            print(f"{kind:9s} {name}: {len(aus)} frames, {mb:.2f} MB stream"
                  f" -> {fps:.1f} fps ({ms:.2f} ms/frame, 1 core)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
