"""Microbench of the JPEG device half (kernel K1) on the card.

The port of ``ultragrid_tpu/tools/bench_jpeg_dev.py``: ``encode_device`` of
a 4K UYVY q80 frame, min over batches of back-to-back launches (interference
only ever adds time), timed by CUDA events on the card and by the host clock
on the CPU.  The reference closed each batch with a dependent scalar fetch,
a workaround for its RPC tunnel that is not ported.

Usage: python -m ultragrid_tpu_torch.tools.bench_jpeg_dev [iters] [--device cpu]
Prints ms/frame for 4K UYVY q80.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
from ultragrid_tpu_torch.tools._bench import device_arg, per_call_ms, sync
from ultragrid_tpu_torch.types import Codec

SIZE = (3840, 2160)


def make_frame(w: int, h: int, device="cuda") -> torch.Tensor:
    rng = np.random.default_rng(0)
    base = (np.linspace(0, 255, w * 2, dtype=np.float32)[None, :]
            + rng.normal(0, 8, (h, 2 * w))).clip(16, 235).astype(np.uint8)
    return torch.from_numpy(base).to(device)


def timeit(fn, frame: torch.Tensor, iters: int = 10, batches: int = 7) -> float:
    """Min-of-batches ms/frame of ``fn(frame)`` after one warm call."""
    fn(frame)
    sync(frame.device)
    return min(per_call_ms(lambda: fn(frame), frame.device, iters) for _ in range(batches))


def main(argv=None) -> int:
    args, device = device_arg(sys.argv[1:] if argv is None else argv)
    iters = int(args[0]) if args else 20
    frame = make_frame(*SIZE, device=device)
    enc = JpegEncoder(*SIZE, in_codec=Codec.UYVY, quality=80)
    ms = timeit(enc.encode_device, frame, iters)
    print(f"4K UYVY->JPEG encode_device: {ms:.2f} ms/frame  ({1e3/ms:.1f} fps)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
