"""Row-sharded own-H.264 intra encode: one slice per band.

Port of ``ultragrid_tpu/parallel/sharded_h264.py``.  H.264 slices reset
intra prediction and the CAVLC contexts, so a band of macroblock rows
encodes exactly like a standalone frame of its height: each device of the
mesh's 'spatial' axis runs the device intra encode
(``ops/h264_device.make_device_encode``) over its own rows, and the host
emits one slice NAL per band through the C assembler
(``native/h264_assemble.c``).  The counterpart of the reference's per-tile
compress fan-out (src/video_compress.cpp:79-120) and of ``sharded_jpeg``'s
restart-aligned bands.

Byte-equal to the reference's ``ShardedH264Encoder`` over the same number of
shards, hence to its host encoder with ``slices`` = the shard count.
"""

from __future__ import annotations

import numpy as np
import torch

from ultragrid_tpu_torch.ops import h264 as H
from ultragrid_tpu_torch.ops.h264_device import (_assemble, _bit_window, _words_to_host, _writer_bits,
                                                 make_device_encode, uyvy_to_planes)
from ultragrid_tpu_torch.parallel.mesh import Mesh


class ShardedH264Encoder:
    def __init__(self, width: int, height: int, mesh: Mesh, qp: int = 26, wwords: int = 80):
        self.mesh = mesh
        self.devices = mesh.spatial
        self.width, self.height = width, height
        self.qp = qp
        self.wwords = wwords
        self.mb_w = (width + 15) // 16
        self.mb_h = (height + 15) // 16
        self.nshards = mesh.shape["spatial"]
        if self.mb_h % self.nshards:
            raise ValueError("MB rows must split evenly over shards")
        self.band_mbh = self.mb_h // self.nshards
        self.headers = H.make_sps(width, height) + H.make_pps(qp)
        self._fns = {}  # (wwords, device) -> the band's encode there

    def _band_fn(self, device: torch.device):
        key = (self.wwords, device)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = make_device_encode(self.width, self.band_mbh * 16, self.qp, self.wwords, device)
        return fn

    def _band_header_row(self, first_mb: int, wwords: int):
        """The band's slice header as one MSB-first window of ``wwords``
        words, and its bit count."""
        hw = H.BitWriter()
        H._slice_header(hw, first_mb, 0, 0, disable_deblock=True)
        val, nbits = _writer_bits(hw)
        return _bit_window(val, nbits, wwords), nbits

    def planes(self, frame):
        """UYVY [H, 2W] (array or tensor) -> per band its 4:2:0 planes,
        edge-padded to whole macroblocks, on its device."""
        rows = self.band_mbh * 16
        src = frame if isinstance(frame, torch.Tensor) else torch.as_tensor(np.ascontiguousarray(frame))
        out = []
        for s, dev in enumerate(self.devices):
            band = src[s * rows: min((s + 1) * rows, self.height)].to(dev)
            out.append(uyvy_to_planes(band, self.width, band.shape[0]))
        return out

    def encode_device(self, planes):
        """-> per band (macroblock words, bit counts, overflow) on its
        device."""
        return [self._band_fn(p[0].device)(*p) for p in planes]

    def encode(self, frame) -> bytes:
        """UYVY [H, 2W] -> Annex-B access unit, one slice per band."""
        planes = self.planes(frame)
        outs = self.encode_device(planes)
        while any(bool(o[2]) for o in outs) and self.wwords < 1024:
            self.wwords *= 2
            outs = self.encode_device(planes)
        nmb_band = self.band_mbh * self.mb_w
        out = [self.headers]
        start = b"\x00\x00\x00\x01" + bytes([(3 << 5) | 5])
        for s, (words, bits, _) in enumerate(outs):
            wn = _words_to_host(words)
            hdr_row, hdr_bits = self._band_header_row(s * nmb_band, wn.shape[1])
            bn = np.concatenate([[hdr_bits], bits.cpu().numpy()])
            out.append(start + _assemble(np.concatenate([hdr_row, wn]), bn))
        return b"".join(out)
