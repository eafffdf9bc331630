"""thumbnailgen: JPEG thumbnails from an ipc_frame preview socket.

The port of ``ultragrid_tpu/tools/thumbnailgen.py`` (counterpart of the
reference's ``tools/thumbnailgen.cpp``): listens on the ``preview`` /
``unix_sock`` display's ipc_frame socket, receives RGB frames (the preview
display already pixel-count-downscales them), and writes JPEG thumbnails
with the port's own encoder: ``JpegEncoder(in_codec=RGB)``, 4:4:4, kernel
K1's RGB template on the card.  The tool runs on the card unless
``--device cpu`` is given; unlike the JAX package's tool it neither forces
the CPU nor falls back to Pillow, so a failing encode raises.

Usage:
    python -m ultragrid_tpu_torch.tools.thumbnailgen [socket_path] -o DIR [-n N] [--device cpu]

then start a sender with ``-F preview`` / ``-d preview`` (or ``-d
unix_socket:path=...``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from ultragrid_tpu_torch.modules.ipc_display import IpcFrameReader
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
from ultragrid_tpu_torch.types import Codec


def write_thumbnail(w: int, h: int, rgb: bytes, path: str, quality: int = 75, device="cuda") -> None:
    """RGB24 bytes -> JPEG file through the port's encoder on ``device``."""
    # the JPEG encoder needs width % 16 / height % 8; pad with edge pixels
    img = np.frombuffer(rgb, np.uint8).reshape(h, w, 3)
    pw = (w + 15) & ~15
    ph = (h + 7) & ~7
    if (pw, ph) != (w, h):
        img = np.pad(img, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    enc = JpegEncoder(pw, ph, in_codec=Codec.RGB, quality=quality)
    data = enc.encode(np.array(img.reshape(ph, pw * 3)), device=device)
    with open(path, "wb") as f:
        f.write(bytes(data))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", nargs="?", default=os.path.join(tempfile.gettempdir(), "ug_preview_disp_unix"))
    p.add_argument("-o", "--out", default=".", help="output directory")
    p.add_argument("-n", type=int, default=1, help="thumbnails to write (0 = forever)")
    p.add_argument("-q", "--quality", type=int, default=75)
    p.add_argument("--device", default="cuda", help="where the JPEG encode runs: cuda (default) or cpu")
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    reader = IpcFrameReader(args.path)
    print(f"listening on {args.path} ...", file=sys.stderr)
    written = 0
    try:
        reader.accept(timeout=3600.0)
        while True:
            got = reader.read_frame(timeout=3600.0)
            if got is None:
                break
            w, h, color, data = got
            if color != Codec.RGB:
                print(f"skipping non-RGB frame ({color.name})", file=sys.stderr)
                continue
            fn = os.path.join(args.out, f"thumb_{written:06d}.jpg")
            write_thumbnail(w, h, data, fn, args.quality, device=args.device)
            print(fn)
            written += 1
            if args.n and written >= args.n:
                break
    finally:
        reader.close()
    return 0 if written else 1


if __name__ == "__main__":
    sys.exit(main())
