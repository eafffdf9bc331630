"""uyvy2yuv422p: raw UYVY frames on stdin -> planar yuv422p on stdout.

The port's copy of ``ultragrid_tpu/tools/uyvy2yuv422p.py`` (jax-free; copied, not imported, so
the port never runs the JAX package's ``__init__``).

Counterpart of the reference's ``tools/uyvy2yuv422p.c`` (a pipe filter used
to feed raw UltraGrid recordings to ffmpeg-style consumers).  Uses the
framework's own planar conversion ops.

Usage: python -m ultragrid_tpu_torch.tools.uyvy2yuv422p <width> <height> < in > out
"""

from __future__ import annotations

import sys

import numpy as np


def convert(width: int, height: int, uyvy: bytes) -> bytes:
    a = np.frombuffer(uyvy, np.uint8).reshape(height, width * 2)
    u = a[:, 0::4]
    y = a[:, 1::2]
    v = a[:, 2::4]
    return y.tobytes() + u.tobytes() + v.tobytes()


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(f"Usage: {sys.argv[0]} <width> <height> < in.uyvy > out.yuv",
              file=sys.stderr)
        return 1
    w, h = int(argv[0]), int(argv[1])
    fsize = w * h * 2
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    while True:
        data = inp.read(fsize)
        if len(data) < fsize:
            break
        out.write(convert(w, h, data))
    return 0


if __name__ == "__main__":
    sys.exit(main())
