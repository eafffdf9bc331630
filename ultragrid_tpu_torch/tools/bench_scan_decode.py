"""Host-side JPEG scan-decode throughput (the receive path's C stage).

The port of ``ultragrid_tpu/tools/bench_scan_decode.py``: measures
``native/jpeg_scan_decode.c`` alone -- entropy decode of a 4K q80 stream
into int16 coefficient arrays -- per thread count (1, 2, 4, 8).  The stream
is made by the port's ``JpegEncoder`` on its device (the card unless
``--device cpu``); the reference had to force its encoder onto the host CPU
for this step, the port does not.  The device dequant + IDCT + UYVY product
is measured elsewhere (``chip_smoke.py``'s receive rows); this isolates the
serial-tail candidate on the receiver host.

Usage: python -m ultragrid_tpu_torch.tools.bench_scan_decode [WxH] [quality] [iters] [--device cpu]
"""

from __future__ import annotations

import ctypes
import sys
import time
from typing import List

import numpy as np
import torch

from ultragrid_tpu_torch.native import jpeg_scan_decode_lib
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder, _parse_headers, _scan_tables
from ultragrid_tpu_torch.tools._bench import device_arg
from ultragrid_tpu_torch.types import Codec

THREADS = (1, 2, 4, 8)


def make_stream(w: int, h: int, quality: int, device: torch.device) -> bytes:
    """A JPEG file of the reference's gradient-and-noise UYVY frame."""
    rng = np.random.default_rng(0)
    base = (np.linspace(0, 255, w * 2, dtype=np.float32)[None, :]
            + rng.normal(0, 8, (h, 2 * w))).clip(16, 235).astype(np.uint8)
    enc = JpegEncoder(w, h, in_codec=Codec.UYVY, quality=quality)
    return bytes(enc.encode(torch.from_numpy(base).to(device)))


class ScanDecoder:
    """The C scan decode of one stream into preallocated int16 [nmcu *
    blocks, 64] arrays per component, at a chosen thread count."""

    def __init__(self, data: bytes, w: int, h: int):
        hdr = _parse_headers(data)
        self.lib = jpeg_scan_decode_lib()
        self.scan = scan = hdr["scan"]
        self.ri = hdr["ri"]
        hmax = max(c["h"] for c in scan)
        vmax = max(c["v"] for c in scan)
        self.nmcu = ((w + 8 * hmax - 1) // (8 * hmax)) * ((h + 8 * vmax - 1) // (8 * vmax))
        self.tables = _scan_tables(hdr)
        self.comp_ntab = np.array([c["td"] for c in scan], np.int32)
        self.comp_nblocks = np.array([c["h"] * c["v"] for c in scan], np.int32)
        self.outs = [np.zeros((self.nmcu * int(nb), 64), np.int16) for nb in self.comp_nblocks]
        self.ptrs = (ctypes.POINTER(ctypes.c_int16) * len(self.outs))(
            *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)) for o in self.outs])
        self.body = np.frombuffer(data[hdr["scan_start"]:], np.uint8)

    def __call__(self, nthreads: int) -> List[np.ndarray]:
        done = self.lib.jpeg_scan_decode_mt(
            self.body.ctypes.data, self.body.size, self.tables.ctypes.data,
            len(self.scan), self.comp_ntab.ctypes.data, self.comp_nblocks.ctypes.data,
            self.nmcu, self.ri, ctypes.cast(self.ptrs, ctypes.c_void_p), nthreads)
        if done != self.nmcu:
            raise RuntimeError(f"scan decode stopped at MCU {done} of {self.nmcu}")
        return self.outs


def run(w: int, h: int, quality: int, iters: int, device: torch.device) -> dict:
    """Encode, then decode ``iters`` times at each thread count; returns
    {threads: (min ms, median ms, a copy of the coefficients)} after printing
    the reference's lines."""
    data = make_stream(w, h, quality, device)
    print(f"{w}x{h} q{quality}: {len(data)/1e6:.2f} MB stream")
    dec = ScanDecoder(data, w, h)
    res = {}
    for nthreads in THREADS:
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            dec(nthreads)
            times.append(time.perf_counter() - t0)
        times.sort()
        res[nthreads] = (times[0] * 1e3, times[len(times) // 2] * 1e3, [o.copy() for o in dec.outs])
        print(f"threads={nthreads}: min {times[0]*1e3:.1f} ms  median {times[len(times)//2]*1e3:.1f} ms",
              flush=True)
    return res


def main(argv=None) -> int:
    args, device = device_arg(sys.argv[1:] if argv is None else argv)
    size = args[0] if len(args) > 0 else "3840x2160"
    quality = int(args[1]) if len(args) > 1 else 80
    iters = int(args[2]) if len(args) > 2 else 8
    w, h = (int(x) for x in size.split("x"))
    run(w, h, quality, iters, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
