"""ipc_frame consumer: listen on a unix socket and dump/inspect frames.

The port's copy of ``ultragrid_tpu/tools/ipc_frame_dump.py`` (counterpart of
the reference's tools/ipc_frame* consumers; the Qt GUI's preview widget
speaks this protocol), over the port's ``IpcFrameReader``.  Host only: the
frames arrive as RGB bytes and are written as they are.  Usage:

    python -m ultragrid_tpu_torch.tools.ipc_frame_dump [path] [--save DIR] [-n N]

then start a sender with ``-d preview`` / ``-d unix_socket:path=<path>``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from ultragrid_tpu_torch.modules.ipc_display import IpcFrameReader
from ultragrid_tpu_torch.types import Codec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", nargs="?", default=os.path.join(tempfile.gettempdir(), "ug_preview_disp_unix"))
    p.add_argument("--save", metavar="DIR", help="save frames as PPM files")
    p.add_argument("-n", type=int, default=0, help="stop after N frames (0 = forever)")
    args = p.parse_args(argv)

    reader = IpcFrameReader(args.path)
    print(f"listening on {args.path} ...", file=sys.stderr)
    try:
        reader.accept(timeout=3600.0)
        i = 0
        while True:
            got = reader.read_frame(timeout=3600.0)
            if got is None:
                break
            w, h, color, data = got
            print(f"frame {i}: {w}x{h} {color.name} {len(data)} B")
            if args.save and color == Codec.RGB:
                fn = os.path.join(args.save, f"frame_{i:06d}.ppm")
                with open(fn, "wb") as f:
                    f.write(f"P6\n{w} {h}\n255\n".encode() + data)
            i += 1
            if args.n and i >= args.n:
                break
    finally:
        reader.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
