"""The control of the cells' correctness check: the timed path computed one
precision lower, TF32 in place of float32, planted in a run and judged by
the benchmark's own check and result line.

    python3 -m ugbench.control --workload <name> --seeds <n,n,...> [--seconds S]

* The sender (:func:`tf32_sender`, planted in this process): the encoder's
  coefficients are the reference's forward transform
  (``reference/jpeg.py``) on the frame's device, its matrix rounded to
  TF32 and summed by a TF32 product, in place of kernel K1; the program's
  own symbol coder, slot pack and C assembly make the file from them.
* The receiver (:func:`tf32_receiver`, planted in the second process): the
  decoder's reverse product with TF32 switched on (the port switches it off
  in ``device.py``); on the CPU, where the port's product is a plain chain,
  the product of the inputs rounded to TF32, as a tensor core rounds them.

For each seed one run of the cell, at its own size and load, for
``--seconds`` (enough to compare as many frames as a run does); the check
has to find each run not correct.  One JSON line a seed: the result line
with the seed.  The benchmark's own runs never plant it.
"""

import argparse
import json
import sys
import time

import numpy as np

from ugbench.reference import jpeg as rjpeg


def tf32(x):
    """float32 tensor values rounded to TF32 (10 explicit mantissa bits), to
    nearest, ties to even."""
    import torch

    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return torch.where(b >= 2**31, b - 2**32, b).to(torch.int32).view(torch.float32)


def _product(a, b):
    """``a @ b`` in float32 with TF32 tensor-core products on the card."""
    import torch

    if not a.is_cuda:
        return a @ b
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep


def blocks_422(uyvy):
    """The reference's :func:`~ugbench.reference.jpeg.blocks_422` on a
    tensor of the frame's device."""
    import torch

    h, w2 = uyvy.shape
    my, mx = h // 8, w2 // 32
    y, cb, cr = uyvy[:, 1::2], uyvy[:, 0::4], uyvy[:, 2::4]
    yb = y.reshape(my, 8, mx, 2, 8).permute(0, 2, 3, 1, 4).reshape(my, mx, 2, 64)
    cbb = cb.reshape(my, 8, mx, 8).permute(0, 2, 1, 3).reshape(my, mx, 1, 64)
    crb = cr.reshape(my, 8, mx, 8).permute(0, 2, 1, 3).reshape(my, mx, 1, 64)
    return torch.cat([yb, cbb, crb], dim=2).reshape(-1, 64)


_FOLDED = {}


def tf32_coefficients(frame, quality: int):
    """Rounded quantised coefficients int64 [nblocks, 64] of a UYVY frame
    tensor: the reference's forward transform with TF32 products."""
    import torch

    key = (quality, frame.device)
    if key not in _FOLDED:
        _FOLDED[key] = [(tf32(w32), 128.0 * w32.sum(dim=0)) for w32 in
                        (torch.as_tensor(w, dtype=torch.float32, device=frame.device)
                         for w in rjpeg.folded_forward(quality))]
    blocks = blocks_422(frame).to(torch.float32)
    comp = torch.as_tensor(np.tile(rjpeg.COMPONENTS_422, blocks.shape[0] // 4), device=frame.device)
    out = torch.empty_like(blocks)
    for c, (w, shift) in enumerate(_FOLDED[key]):
        sel = comp == c
        out[sel] = _product(blocks[sel], w) - shift
    return torch.round(out).to(torch.int64)


def tf32_sender() -> None:
    """Plant the control in the sender's encoder (this process)."""
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder

    def _encode(self, frame):
        q = tf32_coefficients(frame, self.quality).reshape(self.nmcu, -1)
        return self.symbols_and_pack(q, self.wwords)

    JpegEncoder._encode = _encode


def tf32_receiver() -> None:
    """Plant the control in the receiver's decoder (called in the second
    process through ``run_cell(child_setup=...)``)."""
    import torch

    import ultragrid_tpu_torch.device  # noqa: F401 -- it switches TF32 off when imported
    from ultragrid_tpu_torch.ops import jpeg

    torch.backends.cuda.matmul.allow_tf32 = True
    call = jpeg.ChainProduct.__call__

    def product(self, x):
        if x.is_cuda:
            return call(self, x)
        return tf32(x) @ tf32(self.tensors(x.device)[0])

    jpeg.ChainProduct.__call__ = product
    if torch.cuda.is_available():
        a = torch.randn(512, 512, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
        err = float(((a @ a).double() - a.double() @ a.double()).abs().max() / (a.double() @ a.double()).abs().max())
        print(f"control: the receiver's float32 products on the card, relative error {err:.2e} "
              f"(about 1e-7 in float32, 1e-4 in TF32)", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m ugbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    from ugbench import registry, run

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    run._caches()
    import torch

    from ugbench import session

    dev = "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.cuda.get_device_name(0) if dev == "cuda" else "cpu"
    tf32_sender()
    for seed in (int(s) for s in args.seeds.split(",")):
        res = session.run_cell(cfg, traffic, seed, args.seconds, False, dev, time.monotonic_ns(),
                               child_setup="ugbench.control:tf32_receiver")
        out = run.summarize(bench, cell, cfg, res, args.seconds, False, kind)
        line = run.result_line(out, res, cfg)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": "tf32", **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
