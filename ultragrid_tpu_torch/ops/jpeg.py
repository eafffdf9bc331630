"""Baseline JPEG encoder in PyTorch (the port of ``ultragrid_tpu/ops/jpeg.py``).

Same split entropy coder as the reference: the device computes, per 8x8
block, the zigzag-quantised coefficients (one matmul of the raw interleaved
MCU bytes by the "mega matrix"), the Huffman symbols and a fixed-width slot
of MSB-first packed bits; the host C assembler (``native/jpeg_assemble.c``,
shared with the reference) concatenates the slots into byte-stuffed restart
segments and the file.  :meth:`JpegEncoder.encode_file`, the live
sender's route, keeps the frame on its device instead: the entropy assembly
there (:mod:`ultragrid_tpu_torch.ops.jpeg_assemble_cuda`, a kernel on the
card) writes the file as a tensor, and only its length comes to the host.

On a CUDA tensor the device half is ONE hand-written kernel
(:mod:`ultragrid_tpu_torch.ops.jpeg_cuda`); on a CPU tensor it is the plain
PyTorch path :meth:`JpegEncoder.encode_plain`, which is also the kernel's
plain version in the card's checks.  32-bit slot words are ``int32`` tensors
whose bits equal the reference's ``uint32``.

The front end reads only the rows of the mega matrix that are not zero
(:func:`support_plan`); since ``fma(x, 0, acc) == acc`` this equals the
dense product bit for bit.

The Annex K tables below are transcribed once more because the reference
module imports jax; ``tests/test_torch_tables.py`` asserts they equal the
reference's bit for bit.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from ultragrid_tpu_torch import native
from ultragrid_tpu_torch.device import DeviceFile, get_device, host_bytes
from ultragrid_tpu_torch.ops import jpeg_assemble_cuda, jpeg_cuda, jpeg_decode_cuda
from ultragrid_tpu_torch.types import Codec, VideoFrame, vc_get_linesize
from ultragrid_tpu_torch.utils import profiler

# ---------------------------------------------------------------------------
# Tables (JPEG Annex K)
# ---------------------------------------------------------------------------

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)

QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int32)

QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99,
], dtype=np.int32)

# Huffman table specs: (BITS[1..16], HUFFVAL)
DC_LUMA_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_LUMA_VALS = list(range(12))
DC_CHROMA_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
DC_CHROMA_VALS = list(range(12))

AC_LUMA_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]

AC_CHROMA_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]


def build_huffman(bits, vals):
    """Canonical Huffman codes from BITS/HUFFVAL -> (codes[256], lens[256])."""
    codes = np.zeros(256, dtype=np.uint32)
    lens = np.zeros(256, dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            v = vals[k]
            codes[v] = code
            lens[v] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lens


BYTES_PER_BLOCK_CAP = 256  # output budget per 8x8 block (the reference's; worst realistic case)


def pack_tables(codes: np.ndarray, lens: np.ndarray):
    """A 256-entry Huffman table as the reference's packed uint32 tables
    (ref ``pack_tables``, ops/jpeg.py:168): lengths less one as 4-bit
    nibbles (32 words), code low and high bytes four to a word (64 words
    each).  The port's kernels take ``(code << 5) | length`` instead
    (:meth:`JpegEncoder.tables`); this is the reference's public layout."""
    lens_nib = np.zeros(32, dtype=np.uint32)
    for i, ln in enumerate(lens):
        lens_nib[i >> 3] |= np.uint32(max(int(ln) - 1, 0) & 0xF) << ((i & 7) * 4)
    code_lo = np.zeros(64, dtype=np.uint32)
    code_hi = np.zeros(64, dtype=np.uint32)
    for i, c in enumerate(codes):
        code_lo[i >> 2] |= np.uint32(int(c) & 0xFF) << ((i & 3) * 8)
        code_hi[i >> 2] |= np.uint32((int(c) >> 8) & 0xFF) << ((i & 3) * 8)
    return lens_nib, code_lo, code_hi


def scale_quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg/GPUJPEG quality scaling."""
    quality = max(1, min(100, quality))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    tbl = (base * scale + 50) // 100
    return np.clip(tbl, 1, 255).astype(np.int32)


def dct_matrix_64() -> np.ndarray:
    """Flattened 2-D DCT-II as one 64x64 matrix: out_flat = in_flat @ M.T."""
    d = np.zeros((8, 8))
    for k in range(8):
        ck = math.sqrt(0.5) if k == 0 else 1.0
        for n in range(8):
            d[k, n] = 0.5 * ck * math.cos(math.pi * (2 * n + 1) * k / 16.0)
    m = np.einsum("ui,vj->uvij", d, d).reshape(64, 64)
    return m.astype(np.float32)


def support_plan(W: np.ndarray):
    """The compact front end's plan for a mega matrix W [K, 64 * blocks].

    For block group g (columns 64g .. 64g+63), S_g is the ascending list of
    rows of ``W[:, 64g:64g+64]`` with any non-zero entry and Wc_g is
    ``W[S_g, 64g:64g+64]``.  Equal Wc_g are stored once.  Returns
    (rows int32 [sum |S_g|], the S_g one after another; groups int32 [G, 3]
    = (offset of S_g in rows, offset of Wc_g in wc, |S_g|); wc f32 [n, 64],
    the distinct Wc_g one after another).
    """
    W = np.asarray(W, np.float32)
    if W.ndim != 2 or W.shape[1] % 64:
        raise ValueError(f"mega matrix of shape {W.shape} has no 64-column block groups")
    rows, groups, mats = [], [], []
    n_rows = n_wc = 0
    for g in range(W.shape[1] // 64):
        cols = W[:, 64 * g: 64 * g + 64]
        s = np.flatnonzero((cols != 0).any(axis=1)).astype(np.int32)
        wc_g = np.ascontiguousarray(cols[s])
        wo = next((o for o, m in mats if m.shape == wc_g.shape and m.tobytes() == wc_g.tobytes()), None)
        if wo is None:
            wo = n_wc
            mats.append((wo, wc_g))
            n_wc += len(s)
        groups.append((n_rows, wo, len(s)))
        rows.append(s)
        n_rows += len(s)
    wc = np.concatenate([m for _, m in mats]) if n_wc else np.zeros((0, 64), np.float32)
    return (np.concatenate(rows).astype(np.int32), np.asarray(groups, np.int32).reshape(-1, 3),
            wc.astype(np.float32))


# ---------------------------------------------------------------------------
# Plain PyTorch symbol and pack stages (the kernel's plain version)
# ---------------------------------------------------------------------------

_U32 = 1 << 32


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - _U32, x).to(torch.int32)


def _bit_length(v: torch.Tensor) -> torch.Tensor:
    """32 - clz(|v|) as int64, 0 for 0 (frexp is exact on float64)."""
    return torch.frexp(v.abs().to(torch.float64))[1].to(torch.int64)


def _amplitude(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Low s bits of v (v > 0) or of v - 1 (v < 0), as in the reference."""
    return torch.where(v > 0, v, v - 1) & ((torch.ones_like(s) << s) - 1)


def _encode_component_symbols(q, dc_codes, dc_lens, ac_codes, ac_lens, eob, zrl, seg_start):
    """Per-block symbol slots of one component (reference ops/jpeg.py:219).

    q: [nb, 64] int64 zigzagged quantised coefficients in block stream order;
    the tables are int64 tensors of 256 entries, ``eob`` and ``zrl`` their
    (code, length) as ints; seg_start: [nb] bool, True where the DC
    predictor resets.  Returns (lo, ln) [nb, 64] int64: slot 0
    holds the DC symbol, slot j the symbol of coefficient j, the ZRL codes of
    a long zero run ride in the empty slots before its coefficient, and the
    EOB rides in slot 63 (empty exactly when an EOB is needed).
    """
    nb = q.shape[0]
    dc = q[:, 0]
    prev = torch.cat([dc.new_zeros(1), dc[:-1]])
    diff = dc - torch.where(seg_start, 0, prev)
    s_dc = _bit_length(diff)
    sdi = s_dc.clamp(max=15)
    dc_lo = (dc_codes[sdi] << s_dc) | _amplitude(diff, s_dc)
    dc_ln = dc_lens[sdi] + s_dc

    ac = q[:, 1:]
    pos = torch.arange(1, 64, dtype=torch.int64, device=q.device)
    nz = ac != 0
    nz_pos = torch.where(nz, pos, 0)
    cm = torch.cummax(nz_pos, dim=1).values
    prev_nz = torch.cat([cm.new_zeros(nb, 1), cm[:, :-1]], dim=1)
    run = pos - prev_nz - 1
    k_zrl = run >> 4
    s_ac = _bit_length(ac)
    sym = (((run & 0xF) << 4) | s_ac).clamp(max=255)
    val = (ac_codes[sym] << s_ac) | _amplitude(ac, s_ac)
    vlen = ac_lens[sym].clamp(min=1) + s_ac

    zc, zl = zrl
    zz2 = (zc << zl) | zc
    kn = torch.where(nz, k_zrl, 0)
    nxt1 = torch.cat([kn[:, 1:], kn.new_zeros(nb, 1)], dim=1)
    nxt2 = torch.cat([kn[:, 2:], kn.new_zeros(nb, 2)], dim=1)
    pm_lo = torch.where(nxt1 == 1, zc, torch.where(nxt1 >= 2, zz2, torch.where(nxt2 == 3, zc, 0)))
    pm_ln = torch.where(nxt1 == 1, zl, torch.where(nxt1 >= 2, 2 * zl, torch.where(nxt2 == 3, zl, 0)))
    ac_lo = torch.where(nz, val, pm_lo)
    ac_ln = torch.where(nz, vlen, pm_ln)

    need_eob = nz_pos.max(dim=1).values < 63
    ac_lo[:, -1] = torch.where(need_eob, eob[0], ac_lo[:, -1])
    ac_ln[:, -1] = torch.where(need_eob, eob[1], ac_ln[:, -1])
    return (torch.cat([dc_lo[:, None], ac_lo], dim=1),
            torch.cat([dc_ln[:, None], ac_ln], dim=1))


def _pack_block_slots(lo, ln, wwords: int):
    """Pack per-slot bit values into per-block words (reference ops/jpeg.py:311).

    lo/ln: [nbt, 64] int64 values (<= 26 bits) and lengths.  Returns (slots
    [nbt, wwords] int32 holding uint32 bits, MSB first; block_bits [nbt]
    int32; overflow 0-d bool).  Each value touches at most two words; the
    pieces in one word have disjoint bits, so a scatter-add is their OR.
    Words past ``wwords`` go to a discarded column.
    """
    nbt = lo.shape[0]
    cum = torch.cumsum(ln, dim=1)
    off = cum - ln
    block_bits = cum[:, -1]
    overflow = block_bits.max() > wwords * 32
    t = off & 31
    w0 = off >> 5
    d = t + ln
    spans = d > 32
    x0 = torch.where(spans, lo >> (d - 32).clamp(min=0), (lo << ((32 - d) & 31)) & (_U32 - 1))
    x1 = torch.where(spans, (lo << (64 - d).clamp(max=31)) & (_U32 - 1), 0)
    acc = torch.zeros(nbt, wwords + 1, dtype=torch.int64, device=lo.device)
    acc.scatter_add_(1, w0.clamp(max=wwords), x0)
    acc.scatter_add_(1, (w0 + 1).clamp(max=wwords), x1)
    return to_u32_bits(acc[:, :wwords]), block_bits.to(torch.int32), overflow


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

# (subsampling, codec) -> kernel layout id in csrc/jpeg_encode.cu
_LAYOUTS = {
    ("422", Codec.UYVY): 0, ("422", Codec.YUYV): 0,
    ("420", Codec.UYVY): 1, ("420", Codec.YUYV): 1,
    ("444", Codec.RGB): 2, ("444", Codec.RGBA): 3,
}

# the geometries without a mega matrix -> layout id of K1's per-plane entry
# (the plain version: JpegEncoder.plane_coefficients, then symbols and pack)
_PLANE_LAYOUTS = {
    ("444", Codec.UYVY): 0, ("444", Codec.YUYV): 1,
    ("422", Codec.RGB): 2, ("422", Codec.RGBA): 3,
}

_BYTES_PER_PIXEL = {Codec.UYVY: 2, Codec.YUYV: 2, Codec.RGB: 3, Codec.RGBA: 4}


def _fma_chain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x [n, 64] @ m [64, 64] in float32 as one multiply-add per k in
    ascending k: the order of XLA's CPU dot for 64 or more rows."""
    f = torch.zeros(x.shape[0], m.shape[1], dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        f = torch.addcmul(f, x[:, k: k + 1], m[k])
    return f


def _blockify(plane: torch.Tensor) -> torch.Tensor:
    """[H, W] -> [H/8 * W/8, 64] row-major 8x8 blocks (reference
    ``_blockify_plane``)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).permute(0, 2, 1, 3).reshape(-1, 64)

_STATE_KEYS = ("W", "const", "dc_luma", "dc_chroma", "ac_luma", "ac_chroma",
               "quant_luma", "quant_chroma")


class JpegEncoder:
    """Fixed-geometry JPEG encoder (reference ``JpegEncoder``, ops/jpeg.py:377).

    ``state`` optionally replaces the tables this encoder builds itself (see
    :attr:`state` and ``models.encode.state_from_reference``).
    """

    def __init__(
        self,
        width: int,
        height: int,
        in_codec: Codec = Codec.UYVY,
        quality: int = 80,
        restart_interval: Optional[int] = None,
        subsampling: Optional[str] = None,
        state: Optional[dict] = None,
    ):
        self.width, self.height = width, height
        self.in_codec = in_codec
        self.quality = quality
        # 4:2:2 for YCbCr sources, 4:4:4 for RGB; 4:2:0 on request
        if subsampling is None:
            subsampling = "422" if in_codec in (Codec.UYVY, Codec.YUYV) else "444"
        self.subsampling = subsampling
        if subsampling == "420" and in_codec not in (Codec.UYVY, Codec.YUYV):
            raise ValueError("4:2:0 encode supports UYVY/YUYV input")
        self.mcu_w = 16 if subsampling in ("422", "420") else 8
        self.mcu_h = 16 if subsampling == "420" else 8
        if width % self.mcu_w or height % self.mcu_h:
            raise ValueError(
                f"JPEG encoder requires width % {self.mcu_w} == 0 and "
                f"height % {self.mcu_h} == 0 for {subsampling}")
        self.nmcux = width // self.mcu_w
        self.nmcuy = height // self.mcu_h
        self.nmcu = self.nmcux * self.nmcuy
        self.blocks_per_mcu = {"422": 4, "444": 3, "420": 6}[subsampling]
        self.ky = {"422": 2, "420": 4}.get(subsampling, 1)
        if restart_interval is None:
            # >= 512 segments, at most 32 MCUs each, preferring a divisor of
            # the MCU-row width (same choice as the reference)
            restart_interval = max(1, min(32, self.nmcu // 512))
            for ri_c in range(restart_interval, 0, -1):
                if self.nmcux % ri_c == 0:
                    restart_interval = ri_c
                    break
        self.restart_interval = restart_interval
        self.nseg = (self.nmcu + restart_interval - 1) // restart_interval
        self.nblocks = self.nmcu * self.blocks_per_mcu
        self.per_plane = (subsampling, in_codec) in _PLANE_LAYOUTS
        if not self.per_plane and (subsampling, in_codec) not in _LAYOUTS:
            raise ValueError(f"JPEG encoder: no {subsampling} encode from {in_codec.name}")
        # the layout id in csrc/jpeg_encode.cu of the entry this geometry
        # takes: the fused kernel's, or for per-plane the per-plane entry's
        self.layout = (_PLANE_LAYOUTS if self.per_plane else _LAYOUTS)[(subsampling, in_codec)]
        self.bpr = self.mcu_w * _BYTES_PER_PIXEL[in_codec]  # bytes per MCU row

        if state is None:
            state = self._build_state()
        self.state = {k: state[k] for k in _STATE_KEYS}
        want = (64, 128) if self.per_plane else jpeg_cuda.GEOMETRY[self.layout][:2]
        if np.asarray(self.state["W"]).shape != want:
            raise ValueError(f"front-end matrix {np.asarray(self.state['W']).shape} does not "
                             f"fit {subsampling} from {in_codec.name}")
        self.plan = None if self.per_plane else support_plan(self.state["W"])
        self.qtab_luma = np.asarray(self.state["quant_luma"], np.int32)
        self.qtab_chroma = np.asarray(self.state["quant_chroma"], np.int32)
        self._header = self._build_header()
        # slot width in 32-bit words; doubled on overflow
        self.wwords = 16 if quality <= 90 else 32
        self._dev_tables = {}  # torch.device -> device-resident tables
        self._dev_headers = {}  # torch.device -> the header as a uint8 tensor there

    # -- state ----------------------------------------------------------

    def _build_state(self) -> dict:
        qy = scale_quant_table(QUANT_LUMA, self.quality)
        qc = scale_quant_table(QUANT_CHROMA, self.quality)
        build = self._build_plane_matrices if self.per_plane else self._build_mega_matrix
        W, const = build(qy, qc)
        return {
            "W": W, "const": const,
            "dc_luma": build_huffman(DC_LUMA_BITS, DC_LUMA_VALS),
            "dc_chroma": build_huffman(DC_CHROMA_BITS, DC_CHROMA_VALS),
            "ac_luma": build_huffman(AC_LUMA_BITS, AC_LUMA_VALS),
            "ac_chroma": build_huffman(AC_CHROMA_BITS, AC_CHROMA_VALS),
            "quant_luma": qy, "quant_chroma": qc,
        }

    def tables(self, device: torch.device) -> dict:
        """The state as tensors on ``device`` (made once per device)."""
        device = torch.device(device)
        t = self._dev_tables.get(device)
        if t is None:
            st = self.state

            def i64(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            def packed(codes, lens, n):
                return (np.asarray(codes[:n], np.int64) << 5) | np.asarray(lens[:n], np.int64)

            huff = np.concatenate([
                packed(*st["dc_luma"], 16), packed(*st["dc_chroma"], 16),
                packed(*st["ac_luma"], 256), packed(*st["ac_chroma"], 256),
            ]).astype(np.int32)
            tables = {
                "const": torch.as_tensor(np.ascontiguousarray(st["const"], np.float32), device=device),
                "huff": torch.as_tensor(huff, device=device),
                **{name: (i64(st[name][0]), i64(st[name][1]))
                   for name in ("dc_luma", "dc_chroma")},
                # AC tables with their EOB and ZRL (code, length) as ints
                **{name: (i64(st[name][0]), i64(st[name][1]),
                          (int(st[name][0][0]), int(st[name][1][0])),
                          (int(st[name][0][0xF0]), int(st[name][1][0xF0])))
                   for name in ("ac_luma", "ac_chroma")},
            }
            if self.per_plane:
                w = torch.tensor(np.ascontiguousarray(st["W"], np.float32), device=device)
                t = self._dev_tables[device] = {**tables, "w": w, "my": w[:, :64], "mc": w[:, 64:]}
                return t
            rows, groups, wc = self.plan
            # the plain chain, batched over groups: S_g padded at its end
            # with row 0 at weight 0 (fma(x, 0, acc) == acc)
            smax = int(groups[:, 2].max())
            idx = np.zeros((len(groups), smax), np.int64)
            wpad = np.zeros((smax, len(groups), 64), np.float32)
            for g, (ro, wo, n) in enumerate(groups):
                idx[g, :n] = rows[ro: ro + n]
                wpad[:n, g] = wc[wo: wo + n]
            t = {
                **tables,
                "rows": torch.as_tensor(rows, device=device),
                "groups": torch.as_tensor(groups, device=device),
                "wc": torch.as_tensor(wc, device=device),
                "plain_idx": torch.as_tensor(idx, device=device),
                "plain_w": torch.as_tensor(wpad, device=device),
            }
            self._dev_tables[device] = t
        return t

    # -- header ---------------------------------------------------------

    def _build_header(self) -> bytes:
        def marker(m, payload=b""):
            if payload:
                return bytes([0xFF, m]) + (len(payload) + 2).to_bytes(2, "big") + payload
            return bytes([0xFF, m])

        out = marker(0xD8)  # SOI
        out += marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
        # DQT: table 0 luma, 1 chroma, in zigzag order
        out += marker(0xDB, bytes([0]) + bytes(self.qtab_luma[ZIGZAG].tolist()))
        out += marker(0xDB, bytes([1]) + bytes(self.qtab_chroma[ZIGZAG].tolist()))
        # SOF0
        h_y = 2 if self.subsampling in ("422", "420") else 1
        v_y = 2 if self.subsampling == "420" else 1
        sof = bytes([8]) + self.height.to_bytes(2, "big") + self.width.to_bytes(2, "big")
        sof += bytes([3])
        sof += bytes([1, (h_y << 4) | v_y, 0])  # Y
        sof += bytes([2, (1 << 4) | 1, 1])  # Cb
        sof += bytes([3, (1 << 4) | 1, 1])  # Cr
        out += marker(0xC0, sof)
        # DHT
        for cls, tid, (bits, vals) in (
            (0, 0, (DC_LUMA_BITS, DC_LUMA_VALS)),
            (1, 0, (AC_LUMA_BITS, AC_LUMA_VALS)),
            (0, 1, (DC_CHROMA_BITS, DC_CHROMA_VALS)),
            (1, 1, (AC_CHROMA_BITS, AC_CHROMA_VALS)),
        ):
            out += marker(0xC4, bytes([(cls << 4) | tid]) + bytes(bits) + bytes(vals))
        if self.restart_interval:
            out += marker(0xDD, self.restart_interval.to_bytes(2, "big"))
        # SOS
        sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
        out += marker(0xDA, sos)
        return out

    # -- mega matrix ----------------------------------------------------

    def _build_mega_matrix(self, qtab_luma: np.ndarray, qtab_chroma: np.ndarray):
        """One [B, 64*blocks_per_mcu] matrix folding byte deinterleave,
        colour conversion (RGB), the 2-D DCT, zigzag and quantisation
        (reference ops/jpeg.py:516).  Returns (W f32, const f32)."""
        m_zz = dct_matrix_64()[ZIGZAG, :]
        qy = qtab_luma[ZIGZAG].astype(np.float32)
        qc = qtab_chroma[ZIGZAG].astype(np.float32)
        my = (m_zz / qy[:, None]).T  # [rc, k]
        mc = (m_zz / qc[:, None]).T
        cy = 128.0 * my.sum(axis=0)
        cc = 128.0 * mc.sum(axis=0)
        if self.in_codec == Codec.UYVY:
            yoff, uoff, voff = 1, 0, 2
        else:  # YUYV
            yoff, uoff, voff = 0, 1, 3
        if self.subsampling == "422":
            # 16x8 MCU = 32 bytes/row: 2 luma blocks + 1 Cb + 1 Cr
            W = np.zeros((256, 256), np.float32)
            for r in range(8):
                for c in range(8):
                    rc = r * 8 + c
                    W[r * 32 + 2 * c + yoff, 0:64] = my[rc]        # Y left
                    W[r * 32 + 16 + 2 * c + yoff, 64:128] = my[rc]  # Y right
                    W[r * 32 + 4 * c + uoff, 128:192] = mc[rc]      # Cb
                    W[r * 32 + 4 * c + voff, 192:256] = mc[rc]      # Cr
            return W, np.concatenate([cy, cy, cc, cc]).astype(np.float32)
        if self.subsampling == "420":
            # 16x16 MCU = 16 rows x 32 bytes: 4 luma blocks (2x2) + Cb + Cr,
            # the vertical chroma pair-average folded into the matrix
            W = np.zeros((512, 384), np.float32)
            for r in range(8):
                for c in range(8):
                    rc = r * 8 + c
                    W[r * 32 + 2 * c + yoff, 0:64] = my[rc]
                    W[r * 32 + 16 + 2 * c + yoff, 64:128] = my[rc]
                    W[(8 + r) * 32 + 2 * c + yoff, 128:192] = my[rc]
                    W[(8 + r) * 32 + 16 + 2 * c + yoff, 192:256] = my[rc]
                    W[(2 * r) * 32 + 4 * c + uoff, 256:320] += 0.5 * mc[rc]
                    W[(2 * r + 1) * 32 + 4 * c + uoff, 256:320] += 0.5 * mc[rc]
                    W[(2 * r) * 32 + 4 * c + voff, 320:384] += 0.5 * mc[rc]
                    W[(2 * r + 1) * 32 + 4 * c + voff, 320:384] += 0.5 * mc[rc]
            return W, np.concatenate([cy, cy, cy, cy, cc, cc]).astype(np.float32)
        # 4:4:4 RGB/RGBA, 8x8 MCU: JFIF full-range BT.601 colour conversion
        # folded in (the Cb/Cr +128 bias cancels the -128 level shift)
        ncomp = 3 if self.in_codec == Codec.RGB else 4
        W = np.zeros((8 * 8 * ncomp, 192), np.float32)
        color = (
            (0.299, 0.587, 0.114),
            (-0.168735892, -0.331264108, 0.5),
            (0.5, -0.418687589, -0.081312411),
        )
        mats = (my, mc, mc)
        for r in range(8):
            for c in range(8):
                rc = r * 8 + c
                for comp in range(3):
                    for ch in range(3):
                        W[(r * 8 + c) * ncomp + ch, comp * 64: comp * 64 + 64] += (
                            color[comp][ch] * mats[comp][rc]
                        )
        const = np.concatenate([cy, np.zeros(64, np.float32), np.zeros(64, np.float32)])
        return W, const.astype(np.float32)

    def _build_plane_matrices(self, qtab_luma: np.ndarray, qtab_chroma: np.ndarray):
        """The per-plane front end's tables (reference ops/jpeg.py:664-673):
        W = [my | mc] f32 [64, 128], the fused DCT + zigzag + quantisation
        matrix of a luma and of a chroma block, and const = [cy | cc] f32
        [128], the folded -128 level shift of YCbCr planes (0 for RGB, whose
        planes are shifted before the product).  As the reference, in
        float32; each column sum is summed as XLA's CPU reduce sums it: rows
        0-31 and rows 32-63 each in ascending order, then the two halves
        added (found against the reference at ten qualities)."""
        m_zz = dct_matrix_64()[ZIGZAG, :]
        my = (m_zz / qtab_luma[ZIGZAG].astype(np.float32)[:, None]).T
        mc = (m_zz / qtab_chroma[ZIGZAG].astype(np.float32)[:, None]).T
        if self.in_codec in (Codec.RGB, Codec.RGBA):
            const = np.zeros(128, np.float32)
        else:
            def colsum(m):
                halves = []
                for part in (m[:32], m[32:]):
                    acc = np.zeros(64, np.float32)
                    for row in part:
                        acc = (acc + row).astype(np.float32)
                    halves.append(acc)
                return (halves[0] + halves[1]).astype(np.float32)

            const = np.concatenate([np.float32(128.0) * colsum(my), np.float32(128.0) * colsum(mc)])
        return np.concatenate([my, mc], axis=1).astype(np.float32), const.astype(np.float32)

    def planes(self, frame: torch.Tensor):
        """Y, Cb, Cr planes at the coded resolution, as float32 (reference
        ``_planes_from_input``, ops/jpeg.py:483-514, plus the chroma
        resampling that the reference's per-plane path lacks: its
        half-width UYVY chroma cannot fill 4:4:4 blocks, nor its full-width
        RGB chroma 4:2:2 ones, and it raises on both).

        UYVY/YUYV to 4:4:4: each chroma byte is repeated for the two pixels
        it covers; the planes stay unshifted (the level shift is folded into
        ``const``).  RGB/RGBA to 4:2:2: the JFIF colour conversion rounded as
        XLA's CPU compile of the reference rounds it (the middle product
        first, the first and the third fused in, in that order; the Cb/Cr
        +128 bias and the -128 shift cancel, as XLA folds them), then each
        chroma pair is averaged, (a + b) * 0.5.
        """
        w, h = self.width, self.height
        if self.in_codec in (Codec.UYVY, Codec.YUYV):
            g = frame[:, : 2 * w].reshape(h, w // 2, 4)
            if self.in_codec == Codec.UYVY:
                u, y0, v, y1 = g.unbind(-1)
            else:
                y0, u, y1, v = g.unbind(-1)
            y = torch.stack([y0, y1], dim=-1).reshape(h, w)
            u, v = (torch.repeat_interleave(c, 2, dim=1) for c in (u, v))
            return tuple(p.to(torch.float32) for p in (y, u, v))
        ncomp = _BYTES_PER_PIXEL[self.in_codec]
        px = frame[:, : ncomp * w].reshape(h, w, ncomp).to(torch.float32)
        r, g, b = px[..., 0], px[..., 1], px[..., 2]

        def f32(v):
            return torch.tensor(v, dtype=torch.float32, device=frame.device)

        y = torch.addcmul(torch.addcmul(f32(0.587) * g, f32(0.299), r), f32(0.114), b) + f32(-128.0)
        cb = torch.addcmul(torch.addcmul(-(f32(0.331264108) * g), f32(-0.168735892), r), f32(0.5), b)
        cr = torch.addcmul(torch.addcmul(-(f32(0.418687589) * g), f32(0.5), r), f32(-0.081312411), b)
        cb, cr = ((c[:, 0::2] + c[:, 1::2]) * f32(0.5) for c in (cb, cr))
        return y, cb, cr

    def plane_coefficients(self, frame: torch.Tensor) -> torch.Tensor:
        """The per-plane front end: zigzag-quantised coefficients [nmcu,
        64 * blocks_per_mcu] int64 in MCU order (luma blocks, Cb, Cr), each
        block round(block @ m - c) with the product as :func:`_fma_chain`
        (reference ops/jpeg.py:652-681)."""
        self._check_frame(frame)
        t = self.tables(frame.device)
        y, u, v = self.planes(frame)
        if self.subsampling == "422":
            yb = y.reshape(self.nmcuy, 8, self.nmcux, 2, 8).permute(0, 2, 3, 1, 4).reshape(-1, 64)
        else:
            yb = _blockify(y)
        const = t["const"]
        qy = torch.round(_fma_chain(yb, t["my"]) - const[:64])
        quv = torch.round(_fma_chain(torch.cat([_blockify(u), _blockify(v)]), t["mc"]) - const[64:])
        qu, qv = quv.split(self.nmcu)
        return torch.cat([qy.reshape(self.nmcu, -1), qu, qv], dim=1).to(torch.int64)

    # -- device half ----------------------------------------------------

    def _check_frame(self, frame: torch.Tensor) -> None:
        if frame.dtype != torch.uint8 or frame.dim() != 2:
            raise ValueError(f"frame must be uint8 [H, linesize], got {frame.dtype} {tuple(frame.shape)}")
        if frame.shape[0] != self.height or frame.shape[1] < self.nmcux * self.bpr:
            raise ValueError(f"frame shape {tuple(frame.shape)} does not fit {self.width}x{self.height}")

    def mcu_bytes(self, frame: torch.Tensor) -> torch.Tensor:
        """uint8 [H, linesize] -> [nmcu, K] raw interleaved bytes per MCU."""
        self._check_frame(frame)
        return frame[:, : self.nmcux * self.bpr].reshape(
            self.nmcuy, self.mcu_h, self.nmcux, self.bpr
        ).permute(0, 2, 1, 3).reshape(self.nmcu, self.mcu_h * self.bpr)

    def front_end(self, frame: torch.Tensor) -> torch.Tensor:
        """Zigzag-quantised coefficients [nmcu, 64*blocks_per_mcu] int64:
        round(bytes @ W - const) in float32, half to even.

        Content often puts a coefficient exactly on a .5 in exact arithmetic
        (the DCT rows are rational), so the f32 summation order decides its
        rounding.  The product is therefore one multiply-add chain per k in
        ascending k: the order of XLA's CPU dot (the reference) for 64 or
        more MCUs and of kernel K1.  ``torch.matmul`` agrees for K = 256 but
        not for the 4:2:0 matrix (K = 512), on the CPU or in cuBLAS.

        The chain of block group g runs over S_g only (:func:`support_plan`):
        the skipped rows of W are zero, and adding x * 0 leaves a sum as it
        is, so this is the dense chain's result bit for bit at a quarter of
        the work for 4:2:2.  Kernel K1 runs the same chain.
        """
        t = self.tables(frame.device)
        x = self.mcu_bytes(frame).to(torch.float32)
        idx, wpad = t["plain_idx"], t["plain_w"]
        xk = x[:, idx].permute(2, 0, 1).unsqueeze(-1).contiguous()  # [Smax, nmcu, G, 1]
        f = torch.zeros(x.shape[0], idx.shape[0], 64, dtype=torch.float32, device=x.device)
        for k in range(idx.shape[1]):
            f = torch.addcmul(f, xk[k], wpad[k])
        return torch.round(f.reshape(x.shape[0], -1) - t["const"]).to(torch.int64)

    def symbols_and_pack(self, q: torch.Tensor, wwords: int):
        """Coefficients -> (ys, ybits, us, ubits, vs, vbits, overflow)."""
        t = self.tables(q.device)
        nmcu, ri, ky = self.nmcu, self.restart_interval, self.ky
        qy = q[:, : 64 * ky].reshape(nmcu * ky, 64)
        qu = q[:, 64 * ky: 64 * ky + 64]
        qv = q[:, 64 * ky + 64: 64 * ky + 128]
        seg_start = torch.arange(nmcu, device=q.device) % ri == 0
        y_seg_start = torch.zeros(nmcu, ky, dtype=torch.bool, device=q.device)
        y_seg_start[:, 0] = seg_start
        ys, ybits, yovf = _pack_block_slots(*_encode_component_symbols(
            qy, *t["dc_luma"], *t["ac_luma"], y_seg_start.reshape(-1)), wwords)
        us, ubits, uovf = _pack_block_slots(*_encode_component_symbols(
            qu, *t["dc_chroma"], *t["ac_chroma"], seg_start), wwords)
        vs, vbits, vovf = _pack_block_slots(*_encode_component_symbols(
            qv, *t["dc_chroma"], *t["ac_chroma"], seg_start), wwords)
        return ys, ybits, us, ubits, vs, vbits, yovf | uovf | vovf

    def coefficients(self, frame: torch.Tensor) -> torch.Tensor:
        """The front end of this geometry: int64 [nmcu, 64 * blocks]."""
        return self.plane_coefficients(frame) if self.per_plane else self.front_end(frame)

    def encode_plain(self, frame: torch.Tensor):
        """Plain PyTorch device half on any device (reference ``_make_encode``,
        ops/jpeg.py:604), at the current slot width.  frame: uint8 [H,
        linesize].  Returns (ys, ybits, us, ubits, vs, vbits, overflow):
        slots int32 [nb, wwords] (uint32 bits), bit counts int32 [nb],
        overflow 0-d bool."""
        return self.symbols_and_pack(self.coefficients(frame), self.wwords)

    def _encode(self, frame: torch.Tensor):
        """Device half at the current slot width: kernel K1 for a CUDA
        tensor (for a per-plane geometry, K1's per-plane entry), the plain
        path for a CPU tensor.  The overflow flag stays a tensor; callers
        check it when they fetch results."""
        if frame.is_cuda:
            self._check_frame(frame)
            t = self.tables(frame.device)
            if self.per_plane:
                return jpeg_cuda.plane_encode(
                    frame, t["w"], t["const"], t["huff"], layout=self.layout, nmcux=self.nmcux,
                    nmcuy=self.nmcuy, restart_interval=self.restart_interval, wwords=self.wwords)
            return jpeg_cuda.fused_encode(
                frame, t["wc"], t["rows"], t["groups"], t["const"], t["huff"], layout=self.layout,
                nmcux=self.nmcux, nmcuy=self.nmcuy,
                restart_interval=self.restart_interval, wwords=self.wwords)
        if frame.device.type == "cpu":
            return self.encode_plain(frame)
        raise ValueError(f"JPEG encode: unsupported device {frame.device}")

    def escalate_and_retry(self, frame: torch.Tensor):
        """Double the slot width and re-encode."""
        self._widen(self.wwords)
        return self._encode(frame)

    def warm(self, widths=None, device="cuda") -> None:
        """Launch the device half once at each slot width of ``widths``
        (default: the current width and its first escalation), so that a
        mid-stream :meth:`escalate_and_retry` never waits on a build or a
        first launch (reference ``warm``, ops/jpeg.py:756, which compiles its
        graphs ahead).  On the card this builds K1 (for a per-plane geometry,
        its per-plane entry), makes the device tables, loads the kernel and
        leaves the caching allocator holding each width's output blocks; on
        the CPU it runs the plain version.  The slot width is left as it was.
        Call once at start-up, on the device the frames will come on."""
        if widths is None:
            widths = (self.wwords, min(self.wwords * 2, 64))
        dev = get_device(device)
        frame = torch.zeros(self.height, vc_get_linesize(self.width, self.in_codec),
                            dtype=torch.uint8, device=dev)
        keep = self.wwords
        try:
            for ww in widths:
                self.wwords = ww
                self._encode(frame)
        finally:
            self.wwords = keep
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- public ---------------------------------------------------------

    def encode(self, frame, device="cuda") -> np.ndarray:
        """frame: uint8 [H, linesize] -> np.uint8[1-D] complete JPEG file:
        :meth:`encode_file`'s, copied to the host.  A tensor is encoded on
        its own device; an array is copied to ``device`` (the card unless
        the caller names another) and encoded there."""
        return np.asarray(self.encode_file(frame, device))

    def header_tensor(self, device) -> torch.Tensor:
        """The file's header (SOI to SOS) as uint8 on ``device``, made once."""
        device = torch.device(device)
        t = self._dev_headers.get(device)
        if t is None:
            t = self._dev_headers[device] = torch.frombuffer(bytearray(self._header), dtype=torch.uint8).to(device)
        return t

    def _widen(self, used: int) -> None:
        """Double the slot width past ``used``, the width K1 overflowed at."""
        if self.wwords <= used:
            self.wwords = min(used * 2, 64)

    def encode_into(self, frame: torch.Tensor, *, prefix: int = 0, first_segment: int = 0,
                    eoi: bool = True) -> torch.Tensor:
        """K1 and the entropy assembly on the frame's device, nothing on the
        host but one (overflow, length) read: uint8 [prefix + body (+ 2)]
        there, ``prefix`` bytes left for the caller, then the stuffed body,
        its restart markers numbered from ``first_segment``, then the EOI
        where ``eoi``.  K1 runs in ``compress.k1``; the assembly's count
        pass, the read and its write pass in ``compress.assemble``.  Where
        K1 overflows, the slot width is doubled past the width used and K1
        runs again, up to 64 words."""
        while True:
            with profiler.zone("compress.k1"):
                out = self._encode(frame)
            with profiler.zone("compress.assemble"):
                asm = jpeg_assemble_cuda.Assembly(out, ky=self.ky, restart_interval=self.restart_interval,
                                                  first_segment=first_segment)
                over, n = asm.read()
                if not over or out[0].shape[1] >= 64:
                    buf = torch.empty(prefix + n + (2 if eoi else 0), dtype=torch.uint8, device=frame.device)
                    asm.write(buf[prefix:], eoi=eoi)
                    return buf
            self._widen(out[0].shape[1])

    def encode_file(self, frame, device="cuda") -> DeviceFile:
        """frame: uint8 [H, linesize] -> the complete JPEG file as a uint8
        tensor on the frame's device (:class:`DeviceFile`): the slots never
        leave the device (on the card K1 and the assembly kernels, on the
        CPU their plain versions).  An array is copied to ``device``
        first."""
        if not isinstance(frame, torch.Tensor):
            frame = torch.as_tensor(np.asarray(frame), device=get_device(device))
        h = len(self._header)
        file = self.encode_into(frame, prefix=h)
        file[:h].copy_(self.header_tensor(file.device), non_blocking=True)
        return file.as_subclass(DeviceFile)

    def encode_device(self, frame, device="cuda"):
        """The device half without a host sync (reference ``encode_device``,
        ops/jpeg.py:854): (ys, ybits, us, ubits, vs, vbits, overflow).  A
        tensor is encoded on its own device; an array is copied to
        ``device`` (the card unless the caller names another).  Callers check
        the overflow flag when they fetch the parts."""
        if not isinstance(frame, torch.Tensor):
            frame = torch.as_tensor(np.asarray(frame), device=get_device(device))
        return self._encode(frame)

    def assemble(self, ys, ybits, us, ubits, vs, vbits) -> np.ndarray:
        """Merge per-block slots into the stuffed entropy stream with the
        shared C assembler (``native/jpeg_assemble.c``), the independent
        check of the assembly kernel: slots on the card are copied down
        first."""

        def host(a, dt):
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            return np.ascontiguousarray(a).view(dt)

        arrs = [host(a, np.uint32) for a in (ys, us, vs)]
        bitsarr = [host(b, np.int32) for b in (ybits, ubits, vbits)]
        return self.assemble_host(arrs[0], bitsarr[0], arrs[1], bitsarr[1], arrs[2], bitsarr[2])

    def assemble_host(self, ys, ybits, us, ubits, vs, vbits) -> np.ndarray:
        """:meth:`assemble` of slots already on the host: contiguous arrays,
        the slots uint32 and the bit counts int32."""
        lib = native.jpeg_assemble_lib()
        arrs, bitsarr = (ys, us, vs), (ybits, ubits, vbits)
        if arrs[0].shape[0] != self.nmcu * self.ky:
            raise ValueError(f"ys has {arrs[0].shape[0]} rows, expected {self.nmcu * self.ky}")
        total_bits = int(sum(int(b.sum()) for b in bitsarr))
        cap = int(total_bits // 8 + self.nblocks // 4 + 4 * self.nseg + 64)

        def call(capn):
            return lib.jpeg_assemble_3c(
                arrs[0].ctypes.data, bitsarr[0].ctypes.data,
                arrs[1].ctypes.data, bitsarr[1].ctypes.data,
                arrs[2].ctypes.data, bitsarr[2].ctypes.data,
                self.nmcu, self.ky, arrs[0].shape[1], self.restart_interval,
                out.ctypes.data, capn,
            )

        with profiler.zone("compress.assemble"):
            out = np.empty(cap, dtype=np.uint8)
            n = call(cap)
            if n > cap:  # extremely unlikely; retry with the exact size
                out = np.empty(int(n), dtype=np.uint8)
                n = call(int(n))
        return out[:n]


class JpegBatchEncoder:
    """Throughput mode: B frames per K1 launch (reference
    ``JpegBatchEncoder``, ops/jpeg.py:862).

    The frames are stacked row-wise into one taller frame and encoded by one
    launch of K1.  The restart interval divides the MCU-row width, so every
    frame boundary is a restart boundary and each frame's slots, bit counts
    and file are bit-identical to a single-frame encode.  The single-frame
    path stays the sender default: batching trades latency for throughput.
    ``state`` is the tables of :class:`JpegEncoder`; both encoders share them
    and the slot width, and an overflow escalation moves both.
    """

    def __init__(self, width: int, height: int, nframes: int, in_codec: Codec = Codec.UYVY,
                 quality: int = 80, restart_interval: Optional[int] = None,
                 subsampling: Optional[str] = None, state: Optional[dict] = None):
        if nframes < 1:
            raise ValueError(f"batch of {nframes} frames")
        self.nframes = nframes
        self.single = JpegEncoder(width, height, in_codec=in_codec, quality=quality,
                                  restart_interval=restart_interval, subsampling=subsampling, state=state)
        self.tall = JpegEncoder(width, height * nframes, in_codec=in_codec, quality=quality,
                                restart_interval=self.single.restart_interval,
                                subsampling=self.single.subsampling, state=self.single.state)
        # identical entropy geometry, frames on restart boundaries =>
        # per-frame bit-identity
        if self.single.nmcu % self.single.restart_interval or self.tall.nmcux != self.single.nmcux:
            raise ValueError(f"restart interval {self.single.restart_interval} does not divide a "
                             f"frame of {self.single.nmcu} MCUs")
        self.tall.wwords = self.single.wwords

    @property
    def wwords(self) -> int:
        return self.tall.wwords

    def stacked(self, frames, device="cuda") -> torch.Tensor:
        """uint8 [B, H, linesize] or [B*H, linesize] -> the [B*H, linesize]
        tensor: a tensor stays on its own device, an array is copied to
        ``device`` (the card unless the caller names another)."""
        if not isinstance(frames, torch.Tensor):
            frames = torch.as_tensor(np.asarray(frames), device=get_device(device))
        if frames.dim() == 3:
            frames = frames.reshape(self.tall.height, frames.shape[-1])
        return frames

    def encode_device(self, frames, device="cuda"):
        """The device half over the batch: (ys, ybits, us, ubits, vs, vbits,
        overflow) of the tall frame, frame f's blocks at rows f * blocks per
        frame.  One K1 launch on the card."""
        return self.tall._encode(self.stacked(frames, device))

    def encode(self, frames, device="cuda") -> list:
        """-> list of B complete JPEG files (np.uint8 arrays)."""
        f = self.stacked(frames, device)
        out = self.tall._encode(f)
        while bool(out[-1]) and self.tall.wwords < 64:
            out = self.tall.escalate_and_retry(f)
            self.single.wwords = self.tall.wwords
        ys, ybits, us, ubits, vs, vbits = (p.cpu().numpy() for p in out[:-1])
        ky, npm = self.single.ky, self.single.nmcu  # luma blocks per MCU, MCUs per frame
        hdr = np.frombuffer(self.single._header, dtype=np.uint8)
        eoi = np.frombuffer(b"\xff\xd9", dtype=np.uint8)
        files = []
        for i in range(self.nframes):
            sl = slice(i * npm * ky, (i + 1) * npm * ky)
            sc = slice(i * npm, (i + 1) * npm)
            body = self.single.assemble(ys[sl], ybits[sl], us[sc], ubits[sc], vs[sc], vbits[sc])
            files.append(np.concatenate([hdr, body, eoi]))
        return files


# ---------------------------------------------------------------------------
# Host pure-Python decoder (the reference's path for a stream the C scan
# decoder rejects; also an independent test oracle)
# ---------------------------------------------------------------------------


def jpeg_encode_core(frame, width: int, in_codec: Codec, quality: int, device="cuda"):
    """Single-shot device encode (ref ``jpeg_encode_core``, ops/jpeg.py:1244):
    a fresh :class:`JpegEncoder` for the frame's height, and what its
    :meth:`~JpegEncoder.encode_device` returns, as the reference's does:
    (ys, ybits, us, ubits, vs, vbits, overflow), each component's blocks as
    slots padded to the encoder's slot width with their lengths in bits.
    No escalation: the caller checks the overflow flag.  A tensor is encoded
    on its own device; an array is copied to ``device`` (the card unless the
    caller names another)."""
    enc = JpegEncoder(width, frame.shape[0], in_codec=in_codec, quality=quality)
    return enc.encode_device(frame, device=device)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.bitbuf = 0
        self.bitcnt = 0

    def align(self):
        self.bitbuf = 0
        self.bitcnt = 0

    def read_bit(self) -> int:
        if self.bitcnt == 0:
            b = self.data[self.pos]
            self.pos += 1
            if b == 0xFF:
                nxt = self.data[self.pos]
                if nxt == 0x00:
                    self.pos += 1
                else:
                    raise EOFError("marker in entropy stream")
            self.bitbuf = b
            self.bitcnt = 8
        self.bitcnt -= 1
        return (self.bitbuf >> self.bitcnt) & 1


def _huff_decode_map(bits, vals):
    table = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[(length, code)] = vals[k]
            code += 1
            k += 1
        code <<= 1
    return table


def idct_matrix_64() -> np.ndarray:
    """Inverse of :func:`dct_matrix_64` in float64, as float32 (the
    reference's ``np.linalg.inv(dct_matrix_64())`` of the device decoder)."""
    return np.linalg.inv(dct_matrix_64().astype(np.float64)).astype(np.float32)


def decode_jpeg(data: bytes, collect_coeffs: bool = False):
    """Minimal baseline JPEG decoder in numpy (reference ``decode_jpeg``,
    ops/jpeg.py:1034); returns (comps, H, W, sampling).

    comps: list of per-component planes (float, after dequant+IDCT, range
    0..255) at their sampled resolution.
    """
    pos = 2  # skip SOI
    qtabs = {}
    htabs = {}
    ri = 0
    comps_info = []
    h_img = w_img = 0
    while True:
        if data[pos] != 0xFF:
            raise ValueError(f"expected a marker at {pos}, found {data[pos]:#x}")
        m = data[pos + 1]
        pos += 2
        if m == 0xD9:
            break
        ln = int.from_bytes(data[pos: pos + 2], "big")
        payload = data[pos + 2: pos + ln]
        if m == 0xDB:
            p = 0
            while p < len(payload):
                tid = payload[p] & 0xF
                if payload[p] >> 4:
                    raise ValueError("16-bit quantisation tables are not baseline")
                tab = np.zeros(64, np.int32)
                tab[ZIGZAG] = np.frombuffer(payload[p + 1: p + 65], np.uint8)
                qtabs[tid] = tab
                p += 65
        elif m == 0xC4:
            p = 0
            while p < len(payload):
                tc = payload[p] >> 4
                th = payload[p] & 0xF
                bits = list(payload[p + 1: p + 17])
                nv = sum(bits)
                vals = list(payload[p + 17: p + 17 + nv])
                htabs[(tc, th)] = _huff_decode_map(bits, vals)
                p += 17 + nv
        elif m == 0xC0:
            h_img = int.from_bytes(payload[1:3], "big")
            w_img = int.from_bytes(payload[3:5], "big")
            nc = payload[5]
            for c in range(nc):
                cid = payload[6 + 3 * c]
                hv = payload[7 + 3 * c]
                tq = payload[8 + 3 * c]
                comps_info.append({"id": cid, "h": hv >> 4, "v": hv & 0xF, "tq": tq})
        elif m == 0xDD:
            ri = int.from_bytes(payload[:2], "big")
        elif m == 0xDA:
            ns = payload[0]
            scan = []
            for c in range(ns):
                cs = payload[1 + 2 * c]
                tt = payload[2 + 2 * c]
                info = next(ci for ci in comps_info if ci["id"] == cs)
                scan.append({**info, "td": tt >> 4, "ta": tt & 0xF})
            pos += ln
            return _decode_scan(data, pos, scan, qtabs, htabs, ri, h_img, w_img,
                                collect_coeffs=collect_coeffs)
        pos += ln
    raise ValueError("no scan found")


def _decode_scan(data, pos, scan, qtabs, htabs, ri, h_img, w_img, collect_coeffs=False):
    hmax = max(c["h"] for c in scan)
    vmax = max(c["v"] for c in scan)
    mcu_w, mcu_h = 8 * hmax, 8 * vmax
    nmcux = (w_img + mcu_w - 1) // mcu_w
    nmcuy = (h_img + mcu_h - 1) // mcu_h
    nmcu = nmcux * nmcuy
    idct_m = np.linalg.inv(dct_matrix_64().astype(np.float64))
    planes = [
        np.zeros((nmcuy * 8 * c["v"], nmcux * 8 * c["h"]), np.float64) for c in scan
    ]
    coeff_lists = [[] for _ in scan]  # per-component quantized zigzag coeffs
    preds = [0] * len(scan)
    reader = _BitReader(data)
    reader.pos = pos

    def read_huff(table):
        code = 0
        for length in range(1, 17):
            code = (code << 1) | reader.read_bit()
            if (length, code) in table:
                return table[(length, code)]
        raise ValueError("bad huffman code")

    def receive_extend(s):
        if s == 0:
            return 0
        v = 0
        for _ in range(s):
            v = (v << 1) | reader.read_bit()
        if v < (1 << (s - 1)):
            v -= (1 << s) - 1
        return v

    for m in range(nmcu):
        if ri and m and m % ri == 0:
            # expect RST marker
            reader.align()
            if not (data[reader.pos] == 0xFF and 0xD0 <= data[reader.pos + 1] <= 0xD7):
                raise ValueError(f"expected a restart marker at {reader.pos}")
            reader.pos += 2
            preds = [0] * len(scan)
        my, mx = divmod(m, nmcux)
        for ci, comp in enumerate(scan):
            for by in range(comp["v"]):
                for bx in range(comp["h"]):
                    dctab = htabs[(0, comp["td"])]
                    actab = htabs[(1, comp["ta"])]
                    s = read_huff(dctab)
                    diff = receive_extend(s)
                    preds[ci] += diff
                    zzvals = np.zeros(64, np.int64)
                    zzvals[0] = preds[ci]
                    k = 1
                    while k < 64:
                        rs = read_huff(actab)
                        r, s = rs >> 4, rs & 0xF
                        if s == 0:
                            if r == 15:
                                k += 16
                                continue
                            break
                        k += r
                        zzvals[k] = receive_extend(s)
                        k += 1
                    if collect_coeffs:
                        coeff_lists[ci].append(zzvals.copy())
                    # dequant: zzvals are in zigzag order; map back to raster
                    deq = np.zeros(64, np.float64)
                    deq[ZIGZAG] = zzvals * qtabs[comp["tq"]][ZIGZAG]
                    px = idct_m @ deq
                    blk = px.reshape(8, 8) + 128.0
                    yy = (my * comp["v"] + by) * 8
                    xx = (mx * comp["h"] + bx) * 8
                    planes[ci][yy: yy + 8, xx: xx + 8] = blk
    if collect_coeffs:
        coeffs = [np.array(cl, dtype=np.int64) for cl in coeff_lists]
        return planes, h_img, w_img, [(c["h"], c["v"]) for c in scan], coeffs
    return planes, h_img, w_img, [(c["h"], c["v"]) for c in scan]


# ---------------------------------------------------------------------------
# Split JPEG decoder: entropy decode (on the card, or C on the host) +
# dequant/IDCT/pack on tensors
# ---------------------------------------------------------------------------


def _parse_headers(data: bytes):
    """Parse markers up to SOS; returns dict + scan data offset (reference
    ops/jpeg.py:1256)."""
    pos = 2
    qtabs = {}
    htabs_raw = {}
    ri = 0
    comps_info = []
    h_img = w_img = 0
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"expected a marker at {pos}, found {data[pos]:#x}")
        m = data[pos + 1]
        pos += 2
        if m == 0xD9:
            break
        ln = int.from_bytes(data[pos: pos + 2], "big")
        payload = data[pos + 2: pos + ln]
        if m == 0xDB:
            p = 0
            while p < len(payload):
                tid = payload[p] & 0xF
                tab = np.zeros(64, np.int32)
                tab[ZIGZAG] = np.frombuffer(payload[p + 1: p + 65], np.uint8)
                qtabs[tid] = tab
                p += 65
        elif m == 0xC4:
            p = 0
            while p < len(payload):
                tc = payload[p] >> 4
                th = payload[p] & 0xF
                bits = bytes(payload[p + 1: p + 17])
                nv = sum(bits)
                vals = bytes(payload[p + 17: p + 17 + nv])
                htabs_raw[(tc, th)] = (bits, vals)
                p += 17 + nv
        elif m == 0xC0:
            h_img = int.from_bytes(payload[1:3], "big")
            w_img = int.from_bytes(payload[3:5], "big")
            nc = payload[5]
            for c in range(nc):
                comps_info.append(
                    {
                        "id": payload[6 + 3 * c],
                        "h": payload[7 + 3 * c] >> 4,
                        "v": payload[7 + 3 * c] & 0xF,
                        "tq": payload[8 + 3 * c],
                    }
                )
        elif m == 0xDD:
            ri = int.from_bytes(payload[:2], "big")
        elif m == 0xDA:
            ns = payload[0]
            scan = []
            for c in range(ns):
                cs = payload[1 + 2 * c]
                tt = payload[2 + 2 * c]
                info = next(ci for ci in comps_info if ci["id"] == cs)
                scan.append({**info, "td": tt >> 4, "ta": tt & 0xF})
            return {
                "qtabs": qtabs, "htabs": htabs_raw, "ri": ri, "scan": scan,
                "h": h_img, "w": w_img, "scan_start": pos + ln,
            }
        pos += ln
    raise ValueError("no scan found")


# range-packed coefficient upload: max exceptions (|coeff| > 127) per frame
# before the int16 path takes over
_EXC_CAP = 4096


def _scan_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _scan_tables(hdr) -> np.ndarray:
    """The Huffman tables in the C decoder's layout: 4 slots x (16 BITS +
    256 HUFFVAL), slot = table id * 2 + class."""
    tables = np.zeros((4, 272), np.uint8)
    for (tc, th), (bits, vals) in hdr["htabs"].items():
        slot = th * 2 + tc
        tables[slot, :16] = np.frombuffer(bits, np.uint8)
        tables[slot, 16: 16 + len(vals)] = np.frombuffer(vals, np.uint8)
    return tables


def _is_422(hdr) -> bool:
    scan = hdr["scan"]
    return len(scan) == 3 and [(c["h"], c["v"]) for c in scan] == [(2, 1), (1, 1), (1, 1)]


def _scan_decode_int16(data: bytes, hdr, nmcu: int):
    """C scan decode (restart segments across host threads) into int16
    [nmcu * blocks, 64] zigzag coefficients per component, blocks ordered by
    MCU.  Raises ValueError where the decoder stops early."""
    scan = hdr["scan"]
    tables = _scan_tables(hdr)
    comp_ntab = np.array([c["td"] for c in scan], np.int32)
    comp_nblocks = np.array([c["h"] * c["v"] for c in scan], np.int32)
    outs = [np.zeros((nmcu * int(nb), 64), np.int16) for nb in comp_nblocks]
    ptrs = np.array([o.ctypes.data for o in outs], np.uintp)
    body = np.frombuffer(data, np.uint8, offset=hdr["scan_start"])
    done = native.jpeg_scan_decode_lib().jpeg_scan_decode_mt(
        body.ctypes.data, body.size, tables.ctypes.data,
        len(scan), comp_ntab.ctypes.data, comp_nblocks.ctypes.data,
        nmcu, hdr["ri"], ptrs.ctypes.data, _scan_threads(),
    )
    if done != nmcu:
        raise ValueError(f"scan decode stopped at MCU {done}/{nmcu}")
    return outs


def entropy_decode_422(data: bytes):
    """Host half of the split JPEG decoder for 4:2:2 3-component streams
    (reference ops/jpeg.py:1326).

    Returns (hdr, [cy, cu, cv] int16 [nblocks, 64], nmcux, nmcuy), or None
    when the stream is not 4:2:2 with three components."""
    hdr = _parse_headers(data)
    if not _is_422(hdr):
        return None
    nmcux = (hdr["w"] + 15) // 16
    nmcuy = (hdr["h"] + 7) // 8
    return hdr, _scan_decode_int16(data, hdr, nmcux * nmcuy), nmcux, nmcuy


def entropy_decode_422_packed(data: bytes):
    """Packed host half for 4:2:2 3-component streams (reference
    ops/jpeg.py:1374): the C decoder emits the upload layout directly, flat
    int8 ACs (components concatenated, zigzag), an int16 DC column and the
    (index, delta) exception list of the coefficients that do not fit int8.

    Returns (hdr, lo int8 [n*64], dc int16 [n], exc_idx, exc_delta, count,
    nmcux, nmcuy), or None when the stream is not 4:2:2 or has more than
    ``_EXC_CAP`` exceptions (the int16 path, :func:`entropy_decode_422`,
    takes those)."""
    hdr = _parse_headers(data)
    if not _is_422(hdr):
        return None
    scan = hdr["scan"]
    nmcux = (hdr["w"] + 15) // 16
    nmcuy = (hdr["h"] + 7) // 8
    nmcu = nmcux * nmcuy
    tables = _scan_tables(hdr)
    comp_ntab = np.array([c["td"] for c in scan], np.int32)
    comp_nblocks = np.array([c["h"] * c["v"] for c in scan], np.int32)
    nblocks = nmcu * 4  # 2 luma + 1 Cb + 1 Cr per 16x8 MCU
    lo = np.empty(nblocks * 64, np.int8)
    dc = np.empty(nblocks, np.int16)
    nthreads = _scan_threads()
    exc_idx = np.empty(nthreads * _EXC_CAP, np.int32)
    exc_dv = np.empty(nthreads * _EXC_CAP, np.int32)
    exc_count = np.zeros(1, np.int64)
    body = np.frombuffer(data, np.uint8, offset=hdr["scan_start"])
    done = native.jpeg_scan_decode_lib().jpeg_scan_decode_packed_mt(
        body.ctypes.data, body.size, tables.ctypes.data,
        len(scan), comp_ntab.ctypes.data, comp_nblocks.ctypes.data,
        nmcu, hdr["ri"], lo.ctypes.data, dc.ctypes.data,
        exc_idx.ctypes.data, exc_dv.ctypes.data, _EXC_CAP,
        exc_count.ctypes.data, nthreads,
    )
    if done != nmcu:
        raise ValueError(f"scan decode stopped at MCU {done}/{nmcu}")
    count = int(exc_count[0])
    if count < 0 or count > _EXC_CAP:
        return None  # fat frame: the int16 path handles it
    return hdr, lo, dc, exc_idx, exc_dv, count, nmcux, nmcuy


def reverse_mega_matrix(qtab_luma, qtab_chroma) -> np.ndarray:
    """The decoder's [256, 256] float32 matrix (reference
    ``_make_mega_uyvy_fn``, ops/jpeg.py:1541-1558): row = coefficient lane
    [Y left | Y right | U | V] x 64 in zigzag order, column = byte of the
    16x8 MCU's 8 rows x 32 UYVY bytes.  It folds dequantisation (the
    tables in raster order, as the DQT segment gives them), de-zigzag, the
    inverse DCT and the byte interleave; each entry is ``q[k] * idct`` in
    float32."""
    qy = np.asarray(qtab_luma)[ZIGZAG].astype(np.float32)
    qc = np.asarray(qtab_chroma)[ZIGZAG].astype(np.float32)
    v = idct_matrix_64()[:, ZIGZAG].T  # [k, r * 8 + c]
    r, c = np.divmod(np.arange(64), 8)
    W = np.zeros((256, 256), np.float32)
    W[0:64, r * 32 + 2 * c + 1] = qy[:, None] * v  # Y left
    W[64:128, r * 32 + 16 + 2 * c + 1] = qy[:, None] * v  # Y right
    W[128:192, r * 32 + 4 * c] = qc[:, None] * v  # U
    W[192:256, r * 32 + 4 * c + 2] = qc[:, None] * v  # V
    return W


class ChainProduct:
    """``x @ W`` for a static float32 W [K, N]: ``torch.matmul`` on CUDA
    tensors (TF32 off, ``device.py``), and on CPU tensors its plain
    version :meth:`plain`, one multiply-add per k in ascending k, the
    order of XLA's CPU dot (the reference) for 64 or more rows.

    The chain of each output column runs over the rows of W that are not
    zero in it (columns with the same rows share one chain, batched; a
    shorter list is padded with row 0 at weight 0): adding x * 0 leaves a
    sum as it is, so this is the dense chain bit for bit.  The decoder's
    reverse mega matrix has 64 such rows per column, a quarter of K.
    """

    def __init__(self, W: np.ndarray):
        W = np.asarray(W, np.float32)
        self.W = W
        supports = {}
        for j in range(W.shape[1]):
            supports.setdefault(np.flatnonzero(W[:, j]).tobytes(), []).append(j)
        groups = list(supports.items())
        smax = max(1, max(len(np.frombuffer(s, np.int64)) for s, _ in groups))
        cmax = max(len(cols) for _, cols in groups)
        self.idx = np.zeros((len(groups), smax), np.int64)
        self.wpad = np.zeros((smax, len(groups), cmax), np.float32)
        slot = np.zeros(W.shape[1], np.int64)  # column -> its place in [G * cmax]
        for g, (s, cols) in enumerate(groups):
            rows = np.frombuffer(s, np.int64)
            self.idx[g, : rows.size] = rows
            self.wpad[: rows.size, g, : len(cols)] = W[np.ix_(rows, cols)]
            slot[cols] = g * cmax + np.arange(len(cols))
        self.slot = slot
        self._dev = {}  # torch.device -> (W, idx, wpad, slot) there

    def tensors(self, device):
        device = torch.device(device)
        t = self._dev.get(device)
        if t is None:
            t = self._dev[device] = tuple(torch.as_tensor(a, device=device)
                                          for a in (self.W, self.idx, self.wpad, self.slot))
        return t

    def plain(self, x: torch.Tensor) -> torch.Tensor:
        _, idx, wpad, slot = self.tensors(x.device)
        xk = x[:, idx].permute(2, 0, 1).unsqueeze(-1).contiguous()  # [Smax, n, G, 1]
        f = torch.zeros(x.shape[0], idx.shape[0], wpad.shape[2], dtype=torch.float32, device=x.device)
        for k in range(idx.shape[1]):
            f = torch.addcmul(f, xk[k], wpad[k])
        return f.reshape(x.shape[0], -1)[:, slot]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            return torch.matmul(x, self.tensors(x.device)[0])
        if x.device.type == "cpu":
            return self.plain(x)
        raise ValueError(f"JPEG decode product: unsupported device {x.device}")


def _to_pixels(px: torch.Tensor) -> torch.Tensor:
    """f32 sample values -> uint8: +128, round half to even, clip."""
    return torch.clamp(torch.round(px + 128.0), 0, 255).to(torch.uint8)


def packed_coefficients(lo, dc, idx, delta, nmcu: int) -> torch.Tensor:
    """The packed upload of a 4:2:2 stream, on the device -> q float32
    [nmcu, 256], lanes [Y left | Y right | U | V] x 64 in zigzag order
    (reference ops/jpeg.py:1564-1576): the int8 ACs widened, the exception
    deltas added (an integer ``index_add_``, exact in any order; padding
    entries add 0 at index 0), the DC column set."""
    c = lo.to(torch.int32)
    c.index_add_(0, idx, delta)
    c = c.view(-1, 64)
    c[:, 0] = dc.to(torch.int32)
    c = c.view(-1)
    ny = nmcu * 128
    q = torch.cat([c[:ny].view(nmcu, 128), c[ny: ny + nmcu * 64].view(nmcu, 64),
                   c[ny + nmcu * 64:].view(nmcu, 64)], dim=1)
    return q.to(torch.float32)


class _CardStream:
    """What :meth:`JpegDecoder.decode_to_uyvy` keeps of one stream's header
    (the bytes up to and including SOS) for the card's entropy decode: the
    parse, the geometry, the Huffman tables on the device, the decode's
    output (``q``, the status word and its pinned host copy) and the
    reverse product over it, or ``reason``, why the card does not take the
    stream.

    ``band`` (index, count) keeps the state of one of ``count`` equal row
    bands of the frame: its restart segments ``seg0`` to ``seg1`` - 1, its
    ``band_nmcu`` MCUs and ``band_rows`` MCU rows; the whole frame is band
    (0, 1).  A frame whose MCU rows or segments do not split into the bands
    has the reason "bands"."""

    def __init__(self, data: bytes, decoder: "JpegDecoder", band=(0, 1)):
        hdr = _parse_headers(data)
        self.header = bytes(data[: hdr["scan_start"]])
        self.hdr = hdr
        self.nmcux = (hdr["w"] + 15) // 16
        self.nmcuy = (hdr["h"] + 7) // 8
        self.nmcu = self.nmcux * self.nmcuy
        self.ri = hdr["ri"]
        self.band = band
        index, count = band
        self.band_rows = self.nmcuy // count
        self.band_nmcu = self.nmcux * self.band_rows
        self.reason = None
        if not _is_422(hdr) or self.nmcu < 1:
            self.reason = "not 4:2:2"
        elif not self.ri:
            self.reason = "no DRI"
        elif count > 1 and (self.nmcuy % count or self.band_nmcu % self.ri):
            self.reason = "bands"
        else:
            self.tds = tuple(c["td"] for c in hdr["scan"])
            try:
                tables = jpeg_decode_cuda.huffman_tables(hdr["htabs"])
            except ValueError:
                self.reason = "tables"
            else:
                if any(t not in (0, 1) for t in self.tds) or self.tds[1] != self.tds[2]:
                    self.reason = "tables"
        if self.reason is None:
            dev = decoder.device
            self.nseg = -(-self.nmcu // self.ri)
            if count == 1:
                self.seg0, self.seg1 = 0, self.nseg
            else:
                self.seg0 = index * self.band_nmcu // self.ri
                self.seg1 = self.seg0 + self.band_nmcu // self.ri
            self.tables = torch.as_tensor(tables, device=dev)
            self._product = decoder.reverse_product(hdr)
            self.q = torch.empty(self.band_nmcu, 256, dtype=torch.float32, device=dev)
            self.status = torch.empty(4, dtype=torch.int32, device=dev)
            self.status_host = torch.empty(4, dtype=torch.int32, pin_memory=dev.type == "cuda")
            self.offsets = torch.empty(self.nseg, dtype=torch.int64, device=dev)
            self._graph = None
            self._uyvy = None

    def _run(self):
        uyvy = JpegDecoder.uyvy_rows(self._product(self.q), self.nmcux, self.band_rows)
        self.status_host.copy_(self.status, non_blocking=True)
        return uyvy

    def product(self) -> torch.Tensor:
        """UYVY rows of ``q`` through the reverse product, and the status
        word copied to ``status_host``, enqueued.  On the card the chain is
        captured once as a CUDA graph and replayed: one launch a frame in
        place of one per operation, the same kernels on the same
        addresses; the rows are copied out of the graph's buffer."""
        if not self.q.is_cuda:
            return self._run()
        dev = self.q.device
        with torch.cuda.device(dev):  # a band's decoder runs on a card other than the current one
            if self._graph is None:
                # a first run outside the capture sets up cuBLAS on this stream
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self._run()
                torch.cuda.current_stream(dev).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, stream=torch.cuda.Stream(dev), capture_error_mode="thread_local"):
                    self._uyvy = self._run()
                self._graph = graph
            self._graph.replay()
            return self._uyvy.clone()


class JpegDecoder:
    """JPEG -> pixels on ``device`` (the card unless the caller names
    another), then dequantisation, inverse DCT and pixel layout on tensors
    (reference ``JpegDecoder``, ops/jpeg.py:1431).

    The entropy decode of a 4:2:2 three-component stream with restart
    markers runs on the card (:mod:`ultragrid_tpu_torch.ops.jpeg_decode_cuda`)
    when the decoder's device is one; every other stream, and every stream
    on the CPU, takes the C scan decode on the host
    (``native/jpeg_scan_decode.c``), counted in :attr:`host_scans`.  The
    card keeps the state of the last header it saw; a new header builds it
    anew.

    The reverse mega matrix folds the stream's quantisation tables, so it
    is cached under the table VALUES: two streams at different qualities
    share table ids (reference ops/jpeg.py:1509-1513).  The planes path
    dequantises before its IDCT, which depends on no table.
    """

    def __init__(self, device="cuda"):
        self.device = get_device(device)
        self._fns = {}
        self.host_scans = 0  # decode_to_uyvy calls that took the C scan decode
        self._card = self.device.type == "cuda"
        self._stream = None  # the _CardStream of the last header
        # (host uint8, pinned on the card; device uint8, PAD bytes past the
        # file; the decode's tile counts), grown to fit the file
        self._staging = None
        self._done = None  # the event after a frame's last operation

    # -- UYVY fast path ---------------------------------------------------

    def reverse_product(self, hdr) -> ChainProduct:
        """The product with the stream's reverse mega matrix."""
        scan = hdr["scan"]
        qtabs = [hdr["qtabs"][c["tq"]] for c in scan]
        key = ("uyvy", qtabs[0].tobytes(), qtabs[1].tobytes())
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = ChainProduct(reverse_mega_matrix(qtabs[0], qtabs[1]))
        return fn

    @staticmethod
    def uyvy_rows(px: torch.Tensor, nmcux: int, nmcuy: int) -> torch.Tensor:
        """The reverse product ``px`` [nmcu, 256] -> uint8 UYVY rows in
        wire layout."""
        out = _to_pixels(px).view(nmcuy, nmcux, 8, 32)
        return out.permute(0, 2, 1, 3).reshape(nmcuy * 8, nmcux * 32)

    def _make_mega_uyvy_fn(self, hdr, nmcux: int, nmcuy: int, packed: bool = False):
        """The device half of the C path of :meth:`decode_to_uyvy`
        (reference ops/jpeg.py:1541): ``fn(lo, dc, idx, delta)`` for the
        packed upload, ``fn(cy, cu, cv)`` for int16 blocks -> uint8 UYVY rows
        [nmcuy * 8, nmcux * 32] through ONE product with the reverse mega
        matrix."""
        prod = self.reverse_product(hdr)
        nmcu = nmcux * nmcuy
        if packed:
            def fn8(lo, dc, idx, delta):
                return self.uyvy_rows(prod(packed_coefficients(lo, dc, idx, delta, nmcu)), nmcux, nmcuy)

            return fn8

        def fn(cy, cu, cv):
            q = torch.cat([cy.view(nmcu, 128), cu, cv], dim=1).to(torch.float32)
            return self.uyvy_rows(prod(q), nmcux, nmcuy)

        return fn

    def decode_to_uyvy(self, data):
        """4:2:2 3-component JPEG (bytes, or a uint8 array) -> UYVY rows in
        wire layout through ONE product with the reverse mega matrix
        (reference ops/jpeg.py:1493).

        On the card, a stream with restart markers goes up as its file and
        is entropy-decoded there (:meth:`_decode_on_card`); the C scan
        decode takes the rest (:meth:`_decode_on_host`).  Both give the same
        pixels, and raise ValueError for the same corrupt scans.  Returns
        (uyvy uint8 [nmcuy * 8, nmcux * 32] on the device, h, w), or None if
        the stream is not 4:2:2 with three components."""
        if self._card:
            res = self._decode_on_card(data)
            if res is not None:
                return res
        return self._decode_on_host(data if isinstance(data, bytes) else bytes(data))

    def _card_stream(self, data, band=(0, 1)) -> _CardStream:
        """The kept state of ``data``'s header, built anew where the last
        header is not a prefix of ``data`` (``band``: see
        :class:`_CardStream`)."""
        st = self._stream
        if st is None or st.band != band or memoryview(data)[: len(st.header)] != st.header:
            self._stream = None  # the old state goes before the new is built
            st = self._stream = _CardStream(bytes(data), self, band)
        return st

    def _decode_on_card(self, data):
        """The file up once (pinned), the RST markers and the entropy decode
        on the card straight into the reverse product's input, the product,
        then ONE wait for the device: the status word.  None, with a
        ``decompress.fallback`` instant naming why, where the stream needs
        the C path; ValueError where the scan stops early or its restart
        markers are not the interval's, as the C decoder's, counted in
        ``jpeg_decode_cuda.REFUSED`` with the same instant.  ``data``: the
        file as bytes or a uint8 array."""
        issued = self.issue_band(data)
        if issued is None:
            return None
        uyvy, st = issued
        with profiler.zone("decompress.wait"):
            self.check_band(st)
        return uyvy, st.hdr["h"], st.hdr["w"]

    def issue_band(self, data, band=(0, 1), pinned=None):
        """The first half of :meth:`_decode_on_card` for the row band
        ``band`` (index, count) of the frame, the whole frame by default:
        the upload, the entropy decode of the band's restart segments and
        the reverse product of its rows, enqueued on the current stream of
        this decoder's device, with no wait.  ``pinned``: a pinned host
        buffer that already holds ``data`` (another band's decoder put it
        there), copied up from in place of the decoder's own.  Returns
        (UYVY rows of the band, state for :meth:`check_band`), or None with
        a ``decompress.fallback`` instant where the stream needs the C path
        (for a band, the whole frame's)."""
        try:
            st = self._card_stream(data, band)
            reason = st.reason
        except ValueError:
            reason = "header"
        if reason is not None:
            profiler.instant("decompress.fallback", args={"reason": reason})
            return None
        with profiler.zone("decompress.upload"):
            file = self._upload(data, pinned)
        with profiler.zone("decompress.scan"):
            jpeg_decode_cuda.segment_decode(file, len(data), len(st.header), st.tables, st.tds, st.nmcu,
                                            st.ri, out=(st.q, st.status, self._staging[2], st.offsets),
                                            segments=(st.seg0, st.seg1))
        with profiler.zone("decompress.product"):
            uyvy = st.product()
        return uyvy, st

    def check_band(self, st: _CardStream) -> None:
        """The second half: the one wait for the device, on the status word
        of :meth:`issue_band`'s state; ValueError, counted in
        ``jpeg_decode_cuda.REFUSED`` with a ``decompress.fallback`` instant,
        where the scan stopped early in the band's segments or its restart
        markers are not the interval's."""
        stopped, decoded, markers = self._read_status(st)
        if markers != st.nseg - 1:
            reason = "offset count"
            msg = f"scan has {markers} restart markers, the interval gives {st.nseg - 1}"
        elif stopped or decoded != st.band_nmcu:
            reason = "status"
            msg = (f"scan decode stopped at MCU {decoded}/{st.band_nmcu} of segments {st.seg0}-{st.seg1} "
                   f"({stopped} segments stopped early)")
        else:
            return
        jpeg_decode_cuda.REFUSED.add(self.device)
        profiler.instant("decompress.fallback", args={"reason": reason})
        raise ValueError(msg)

    def _upload(self, data, pinned=None) -> torch.Tensor:
        """``data`` copied into the reused staging buffer (pinned on the
        card), then one asynchronous copy to the device buffer, which holds
        ``PAD`` bytes more; on the card both in one call
        (:func:`jpeg_decode_cuda.upload`).  ``pinned``: a pinned buffer
        that holds ``data`` already, copied up from alone."""
        need = len(data) + jpeg_decode_cuda.PAD
        if self._staging is None or self._staging[0].numel() < need:
            size = 1 << (need - 1).bit_length()
            self._staging = (torch.empty(size, dtype=torch.uint8, pin_memory=self.device.type == "cuda"),
                             torch.empty(size, dtype=torch.uint8, device=self.device),
                             torch.empty(size // jpeg_decode_cuda.TILE + 1, dtype=torch.int32, device=self.device))
        host, dev = self._staging[:2]
        if pinned is not None:
            dev[: len(data)].copy_(pinned[: len(data)], non_blocking=True)
            return dev
        src = np.frombuffer(data, np.uint8)
        if dev.is_cuda:
            jpeg_decode_cuda.upload(host, src, dev)
        else:
            dev.numpy()[: src.size] = src
        return dev

    @property
    def staging_host(self) -> Optional[torch.Tensor]:
        """The pinned host buffer that holds the last file :meth:`_upload`
        copied up without a ``pinned`` buffer."""
        return None if self._staging is None else self._staging[0]

    def _read_status(self, st: _CardStream):
        """The frame's one host read of the device: the status word, which
        the product's chain copies into pinned memory after every operation
        of the frame."""
        if self.device.type == "cuda":
            if self._done is None:
                self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(self.device))
            if not self._done.query():  # a finished frame keeps the interpreter lock
                self._done.synchronize()
        return st.status_host.tolist()[:3]

    def _decode_on_host(self, data: bytes):
        """The C scan decode on the host, then the upload and the product.

        The packed layout goes up as int8 ACs, an int16 DC column and the
        exception list padded to ``_EXC_CAP`` entries; a frame with more
        exceptions goes up as int16 blocks."""
        self.host_scans += 1
        with profiler.zone("decompress.scan"):
            packed = entropy_decode_422_packed(data)
        if packed is not None:
            hdr, lo, dc, exc_idx, exc_dv, count, nmcux, nmcuy = packed
            idx = np.zeros(_EXC_CAP, np.int64)
            dv = np.zeros(_EXC_CAP, np.int32)
            idx[:count] = exc_idx[:count]
            dv[:count] = exc_dv[:count]
            fn = self._make_mega_uyvy_fn(hdr, nmcux, nmcuy, packed=True)
            return self._upload_and_run(fn, (lo, dc, idx, dv)), hdr["h"], hdr["w"]
        with profiler.zone("decompress.scan"):
            decoded = entropy_decode_422(data)
        if decoded is None:
            return None
        hdr, outs, nmcux, nmcuy = decoded
        fn = self._make_mega_uyvy_fn(hdr, nmcux, nmcuy)
        return self._upload_and_run(fn, outs), hdr["h"], hdr["w"]

    def _upload_and_run(self, fn, arrays):
        """The scan decode's arrays up to the device, then ``fn`` (the
        reverse product) on them."""
        with profiler.zone("decompress.upload"):
            args = [torch.as_tensor(a, device=self.device) for a in arrays]
        with profiler.zone("decompress.product"):
            return fn(*args)

    # -- planes path (any sampling) ---------------------------------------

    def idct_product(self) -> ChainProduct:
        fn = self._fns.get("idct")
        if fn is None:
            fn = self._fns["idct"] = ChainProduct(idct_matrix_64().T)
        return fn

    def _make_device_fn(self, hdr, nmcux: int, nmcuy: int):
        """The device half of :meth:`decode` (reference ops/jpeg.py:1602):
        ``fn(*coeffs)``, int16 [blocks, 64] zigzag coefficients per
        component -> uint8 planes: dequantise, un-zigzag, IDCT, blocks ->
        plane."""
        scan = hdr["scan"]
        dev = self.device
        idct = self.idct_product()
        zz_inv = torch.as_tensor(_ZIGZAG_INV, device=dev)
        qs = [torch.as_tensor(hdr["qtabs"][c["tq"]][ZIGZAG].astype(np.float32), device=dev) for c in scan]

        def fn(*coeffs):
            planes = []
            for comp, q, co in zip(scan, qs, coeffs):
                raster = (co.to(torch.float32) * q[None, :])[:, zz_inv]
                px = _to_pixels(idct(raster))
                hq, vq = comp["h"], comp["v"]
                blocks = px.view(nmcuy, nmcux, vq, hq, 8, 8)
                planes.append(blocks.permute(0, 2, 4, 1, 3, 5).reshape(nmcuy * vq * 8, nmcux * hq * 8))
            return tuple(planes)

        return fn

    def decode(self, data: bytes):
        """Returns (planes, h, w, sampling): Y/Cb/Cr uint8 tensors on the
        device, each at its sampled resolution (reference ops/jpeg.py:1438)."""
        with profiler.zone("decompress.scan"):
            hdr = _parse_headers(data)
            scan = hdr["scan"]
            hmax = max(c["h"] for c in scan)
            vmax = max(c["v"] for c in scan)
            nmcux = (hdr["w"] + 8 * hmax - 1) // (8 * hmax)
            nmcuy = (hdr["h"] + 8 * vmax - 1) // (8 * vmax)
            outs = _scan_decode_int16(data, hdr, nmcux * nmcuy)
        planes = self._upload_and_run(self._make_device_fn(hdr, nmcux, nmcuy), outs)
        return planes, hdr["h"], hdr["w"], [(c["h"], c["v"]) for c in scan]


# raster position j -> its index in zigzag order
_ZIGZAG_INV = np.argsort(ZIGZAG)


def decode_jpeg_device(data: bytes, device="cuda"):
    """Planes of a JPEG stream on ``device`` (reference ops/jpeg.py:1634)."""
    return JpegDecoder(device).decode(data)


def decode_jpeg_to_frame(frame: VideoFrame, out_codec: Codec,
                         decoder: Optional[JpegDecoder] = None, device="cuda",
                         uyvy_decoder=None) -> Optional[VideoFrame]:
    """Receiver-side JPEG decode to UYVY or RGB (reference
    ops/jpeg.py:1181), on ``decoder``'s device, or a new decoder's on
    ``device`` (the card unless the caller names another).  The frame's
    data is a uint8 tensor there.  ``uyvy_decoder`` takes the UYVY decode
    in ``decoder``'s place (``ShardedJpegDecoder``, whose
    ``decode_frame`` gathers its bands onto ``decoder``'s device).

    UYVY from 4:2:2: the entropy decode (on the card where the stream has
    restart markers, else the C scan decode) and one reverse mega product.  Other
    samplings, and RGB, take the planes path, then chroma upsampling and
    colour conversion in float64 (as the reference's numpy).  Where the C
    scan decoder rejects the stream (``ValueError``), the reference's own
    answer is its pure-Python decoder on the host, and so it is here;
    nothing else falls back."""
    dec = decoder if decoder is not None else JpegDecoder(device)
    arr = host_bytes(frame.data)
    if out_codec == Codec.UYVY:
        try:
            res = dec.decode_to_uyvy(arr) if uyvy_decoder is None else uyvy_decoder.decode_frame(arr)
        except ValueError:
            res = None
        if res is not None:
            uyvy, h, w = res
            vf = VideoFrame(frame.desc.with_(color_spec=Codec.UYVY), [uyvy[:h, : 2 * w]])
            vf.timestamp = frame.timestamp
            return vf
    data = bytes(arr)
    try:
        planes, h, w, sampling = dec.decode(data)
        y, cb, cr = (p.to(torch.float64) for p in planes)
    except ValueError:
        planes, h, w, sampling = decode_jpeg(data)
        y, cb, cr = (torch.as_tensor(np.clip(np.round(p), 0, 255), device=dec.device) for p in planes)
    hs, vs = sampling[0]
    if vs == 2:  # 4:2:0 (RFC 2435 type 1): chroma is half height; repeat rows
        cb = torch.repeat_interleave(cb, 2, dim=0)
        cr = torch.repeat_interleave(cr, 2, dim=0)
    if hs == 1 and out_codec == Codec.UYVY:  # 4:4:4 -> subsample horizontally
        cb = cb[:, 0::2]
        cr = cr[:, 0::2]
    if out_codec == Codec.UYVY:
        out = torch.zeros(h, 2 * w, dtype=torch.uint8, device=dec.device)
        out[:, 1::2] = y[:h, :w]
        out[:, 0::4] = cb[:h, : w // 2]
        out[:, 2::4] = cr[:h, : w // 2]
        vf = VideoFrame(frame.desc.with_(color_spec=Codec.UYVY), [out])
        vf.timestamp = frame.timestamp
        return vf
    if out_codec == Codec.RGB:
        if hs == 2:
            cb = torch.repeat_interleave(cb, 2, dim=1)[:, :w]
            cr = torch.repeat_interleave(cr, 2, dim=1)[:, :w]
        y = y[:h, :w]
        cb = cb[:h, :w] - 128.0
        cr = cr[:h, :w] - 128.0
        r = y + 1.402 * cr
        g = y - 0.344136 * cb - 0.714136 * cr
        b = y + 1.772 * cb
        rgb = torch.stack([r, g, b], dim=-1)
        rgb = torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8).reshape(h, 3 * w)
        vf = VideoFrame(frame.desc.with_(color_spec=Codec.RGB), [rgb])
        vf.timestamp = frame.timestamp
        return vf
    return None
