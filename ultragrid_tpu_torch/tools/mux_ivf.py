"""mux_ivf: wrap per-frame VP8/VP9/AV1 files into an IVF stream.

The port's copy of ``ultragrid_tpu/tools/mux_ivf.py`` (jax-free; copied, not imported, so
the port never runs the JAX package's ``__init__``).

Counterpart of the reference's ``tools/mux_ivf.c``: same CLI
(``mux_ivf <width> <height> <fps> INFILES > out.ivf``), same DKIF layout —
32-byte file header (version 0, fourcc from the first file's extension)
plus a 12-byte header (size, 8-byte pts) per frame.  Input frames come from
a ``-E``/dump recording of a VP8/VP9/AV1 stream.
"""

from __future__ import annotations

import os
import struct
import sys

FCC = {"vp8": b"VP80", "vp9": b"VP90", "av1": b"av01"}


def mux(width: int, height: int, fps: int, infiles, out) -> None:
    ext = os.path.splitext(infiles[0])[1].lstrip(".").lower()
    fcc = FCC.get(ext)
    if fcc is None:
        raise ValueError(f"unsupported extension: {ext}")
    nf = len(infiles)
    out.write(b"DKIF")
    out.write(struct.pack("<HH4sHHIIII", 0, 32, fcc, width, height, fps, 1, nf, 0))
    for pts, path in enumerate(infiles):
        data = open(path, "rb").read()
        out.write(struct.pack("<IQ", len(data), pts))
        out.write(data)


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 4:
        print(f"Usage:\n\t{sys.argv[0]} <width> <height> <fps> INFILES > out.ivf",
              file=sys.stderr)
        return 1
    width, height, fps = int(argv[0]), int(argv[1]), int(argv[2])
    mux(width, height, fps, argv[3:], sys.stdout.buffer)
    return 0


if __name__ == "__main__":
    sys.exit(main())
