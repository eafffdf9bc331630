"""The multi-device dry run: every sharded path once, on tiny shapes.

The port's counterpart of the repository root's
``__graft_entry__.dryrun_multichip``, with its seven steps and their
asserts, over a mesh of ``n_devices`` entries: CUDA cards by default, the
CPU with ``device="cpu"``, or any ``devices`` list (``["cuda:0"] * 4`` puts
four bands on one card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.ops.fec import Gf2Parity, build_ldgm_matrix
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
from ultragrid_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_frame_rows
from ultragrid_tpu_torch.parallel.sharded_h264 import ShardedH264Encoder
from ultragrid_tpu_torch.parallel.sharded_jpeg import (ShardedJpegDecoder, ShardedJpegEncoder,
                                                       ShardedReceiverStep, ShardedSenderStep, band_symbols)
from ultragrid_tpu_torch.parallel.sharded_post import sharded_deinterlace
from ultragrid_tpu_torch.types import Codec, vc_get_linesize


def column_sharded_parity(parts, mesh, k: int, m: int, c: int):
    """Step 1b: LDGM parity (staircase on) over the whole frame's slot
    container ``[k, ps]`` = [u32 0][Y slots][Y bits][U slots][U bits][V
    slots][V bits][zero pad] (the bands' parts concatenated), with its
    symbol columns split over the mesh's devices: GF(2) parity is
    column-local, so each device's K2 takes its own column strip.  Returns
    the parity strips [m, strip words] int32, one per device."""
    dev0 = mesh.spatial[0]
    words = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev0)] +
                      [torch.cat([p[i].reshape(-1).to(dev0) for p in parts]) for i in range(6)])
    nbytes = words.numel() * 4
    ps = -(-nbytes // (k * 4)) * 4
    container = torch.zeros(k * ps // 4, dtype=torch.int32, device=dev0)
    container[: words.numel()] = words
    container = container.reshape(k, ps // 4)
    mask = build_ldgm_matrix(k, m, c, 1)
    strips = torch.tensor_split(container, len(mesh.spatial), dim=1)
    return [Gf2Parity(mask, s.shape[1])(s.to(d).contiguous()) for s, d in zip(strips, mesh.spatial)], ps


def dryrun_multichip(n_devices: int, device="cuda", devices: Optional[Sequence] = None) -> None:
    """Run the full pipeline's sharded steps over an ``n_devices`` mesh on
    tiny shapes; every assert of the reference's dry run holds."""
    mesh_devices = None if devices is None else list(devices)[:n_devices]
    mesh1 = make_mesh(n_devices, data=1, devices=mesh_devices, device=device)

    # 1) the flagship encode, spatially sharded: JPEG of one frame with its
    #    MCU rows split over all devices (2 MCU rows per device)
    width = 96
    height = 8 * 2 * n_devices
    ls = vc_get_linesize(width, Codec.UYVY)
    frame = np.zeros((height, ls), dtype=np.uint8)
    enc = ShardedJpegEncoder(width, height, mesh1, in_codec=Codec.UYVY, quality=80)
    parts = enc.encode_device(frame)
    assert sum(p[0].shape[0] for p in parts) == enc.full.nmcu * 2  # Y slots across all bands

    # 1b) the encode's parts + LDGM parity over the whole frame's container,
    #     its symbol columns split over the devices
    k, m, c = 8, 4, 3
    strips, ps = column_sharded_parity(parts, mesh1, k, m, c)
    assert all(s.shape[0] == m for s in strips) and sum(s.shape[1] for s in strips) * 4 == ps

    # 2) data x spatial mesh: a batch of frames converted with rows split
    data_ax = 2 if n_devices % 2 == 0 else 1
    mesh2 = make_mesh(n_devices, data=data_ax, devices=mesh_devices, device=device)
    spatial = n_devices // data_ax
    frames = np.zeros((data_ax, 8 * spatial, ls), dtype=np.uint8)
    blocks = shard_batch(frames, mesh2)
    out = [[torch.stack([pixfmt.convert_frame(f, width, Codec.UYVY, Codec.RGB) for f in blk]) for blk in row]
           for row in blocks]
    expected_ls = vc_get_linesize(width, Codec.RGB)
    shape = (data_ax, sum(b.shape[1] for b in out[0]), out[0][0].shape[2])
    assert shape == (data_ax, 8 * spatial, expected_ls), shape
    assert all(b.device == d for row, drow in zip(out, mesh2.grid) for b, d in zip(row, drow))

    # 3) the second codec family sharded: own H.264 intra, one slice per
    #    device (one macroblock row each)
    h264_h = 16 * n_devices
    h264_frame = np.zeros((h264_h, ls), np.uint8)
    bs = ShardedH264Encoder(width, h264_h, mesh1, qp=26).encode(h264_frame)
    assert bytes(bs[:4]) == b"\x00\x00\x00\x01"

    # 4) the receive side sharded: host entropy decode, the reverse mega
    #    product per band (one MCU row each)
    dec_h = 8 * n_devices
    small = JpegEncoder(width, dec_h, in_codec=Codec.UYVY, quality=80)
    jpeg_bytes = bytes(small.encode(np.zeros((dec_h, ls), np.uint8), device=mesh1.spatial[0]))
    res = ShardedJpegDecoder(mesh1).decode_to_uyvy(jpeg_bytes)
    assert res is not None and (sum(b.shape[0] for b in res[0]), res[0][0].shape[1]) == (dec_h, ls)

    # 5) the halo-exchange postprocess: deinterlace takes the next block's
    #    first row
    di_frame = np.zeros((2 * n_devices, ls), np.uint8)
    out_di = sharded_deinterlace(di_frame, Codec.UYVY, mesh1, kind="blend")
    assert (sum(b.shape[0] for b in out_di), out_di[0].shape[1]) == di_frame.shape

    # 6) the full sender step as deployed: per-device JPEG + LDGM parity,
    #    every output on its band's device
    step6 = ShardedSenderStep(width, height, mesh1, quality=80, k=16, m=6, c=3)
    outs = step6(shard_frame_rows(frame, mesh1))
    assert len(outs) == n_devices
    for band, dev in zip(outs, mesh1.spatial):
        assert band[6].shape == (step6.m, step6.ps)
        assert all(o.device == dev for o in band)

    # 7) the full receiver step as deployed: per-band peel on its device,
    #    band-local host entropy decode, per-band reverse product; one data
    #    symbol erased per band
    sym7 = np.stack([band_symbols(band, step6.row_counts, step6.ps, step6.k) for band in outs])
    present7 = np.ones((n_devices, step6.k + step6.m), bool)
    present7[:, 0] = False
    lossy7 = sym7.copy()
    lossy7[:, 0] = 0
    rx7 = ShardedReceiverStep(width, height, mesh1, quality=80, k=step6.k, m=step6.m, c=step6.c,
                              wwords=step6.base.local.wwords)
    uyvy7, ok7 = rx7(lossy7, present7)
    assert ok7.all()
    assert (sum(b.shape[0] for b in uyvy7), uyvy7[0].shape[1]) == (height, ls)
    assert [b.device for b in uyvy7] == mesh1.spatial  # never gathered
