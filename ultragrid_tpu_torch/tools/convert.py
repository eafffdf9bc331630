"""convert: pixel-format conversion CLI (ref: tools/convert.c).

The port of ``ultragrid_tpu/tools/convert.py``: each frame of the input file
is uploaded once, converted by ``ops/pixfmt.convert_frame`` on the card (or
on ``--device cpu``) and written back.

Usage: ``python -m ultragrid_tpu_torch.tools.convert WxH IN_CODEC in.raw OUT_CODEC out.raw [--device cpu]``
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.tools._bench import device_arg
from ultragrid_tpu_torch.types import Codec, get_codec_from_name, vc_get_linesize


def main(argv=None) -> int:
    argv, device = device_arg(argv if argv is not None else sys.argv[1:])
    if len(argv) != 5:
        print(__doc__, file=sys.stderr)
        return 1
    size, in_name, in_path, out_name, out_path = argv
    w, _, h = size.partition("x")
    width, height = int(w), int(h)
    in_codec = get_codec_from_name(in_name)
    out_codec = get_codec_from_name(out_name)
    if Codec.NONE in (in_codec, out_codec):
        print("unknown codec", file=sys.stderr)
        return 1
    ls = vc_get_linesize(width, in_codec)
    data = np.fromfile(in_path, dtype=np.uint8)
    frames = data.size // (ls * height)
    if frames == 0:
        print("input too small", file=sys.stderr)
        return 1
    out_ls = vc_get_linesize(width, out_codec)
    with open(out_path, "wb") as f:
        for i in range(frames):
            frame = torch.from_numpy(data[i * ls * height : (i + 1) * ls * height].reshape(height, ls)).to(device)
            out = pixfmt.convert_frame(frame, width, in_codec, out_codec, device=device)
            f.write(out.cpu().numpy().tobytes())
    print(f"converted {frames} frame(s) {in_name} -> {out_name} ({out_ls * height} B/frame)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
