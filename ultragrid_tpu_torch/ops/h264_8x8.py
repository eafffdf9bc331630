"""H.264 High-profile 8x8 transform primitives (decoder side).

Shared by the CAVLC (:mod:`h264_dec`) and CABAC (:mod:`h264_cabac`)
slice decoders: the 8x8 zig-zag scan (Table 8-8), dequantization
(8.5.13.1 — flat weightScale8x8 = 16; streams carrying scaling lists are
out of envelope and rejected at parse time), the 8x8 inverse transform
(8.5.13.2 butterfly), and Intra_8x8 prediction with the reference-sample
low-pass filter (8.3.2.2.1) that distinguishes 8x8 from 4x4 intra.

Reference role: the High-profile half of the decode path the reference
reaches through FFmpeg (src/video_decompress/libavcodec.c); this is a
from-scratch spec implementation, conformance-gated by sample-exact
decode of libx264 ``profile=high`` (8x8dct on — the encoder default)
streams vs libavcodec in tests/test_h264_cabac.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# 8x8 zig-zag scan (Table 8-8, frame coding): scan position -> raster idx
ZZ8 = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int64)

# Dequant norm-adjust values (8.5.13.1), rows = qP % 6; the 6 columns are
# selected per (i, j) position by _V8_CLASS below
_V8 = np.array([
    [20, 18, 32, 19, 25, 24],
    [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31],
    [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38],
    [36, 32, 58, 34, 46, 43],
], np.int64)


def _v8_class(i: int, j: int) -> int:
    if i % 4 == 0 and j % 4 == 0:
        return 0
    if i % 2 == 1 and j % 2 == 1:
        return 1
    if i % 4 == 2 and j % 4 == 2:
        return 2
    if (i % 4 == 0 and j % 2 == 1) or (i % 2 == 1 and j % 4 == 0):
        return 3
    if (i % 4 == 0 and j % 4 == 2) or (i % 4 == 2 and j % 4 == 0):
        return 4
    return 5


_V8_CLASS = np.array([[_v8_class(i, j) for j in range(8)] for i in range(8)],
                     np.int64)

_VMAT8_CACHE = {}


def vmat8(qp: int) -> np.ndarray:
    """LevelScale8x8(qp % 6) with the flat (16) weight matrix folded out:
    dequant multiplies by this and shifts per :func:`dequant8`."""
    m = _VMAT8_CACHE.get(qp % 6)
    if m is None:
        m = _V8[qp % 6][_V8_CLASS]
        _VMAT8_CACHE[qp % 6] = m
    return m


def dezigzag8(zz: np.ndarray) -> np.ndarray:
    out = np.zeros(64, np.int64)
    out[ZZ8] = zz
    return out.reshape(8, 8)


def dequant8(c: np.ndarray, qp: int) -> np.ndarray:
    """8.5.13.1: LevelScale8x8 = weightScale8x8 * normAdjust8x8 with the
    flat weightScale8x8 = 16, so the multiplier is 16 * vmat8 (verified
    coefficient-by-coefficient against libavcodec with single-coefficient
    probe streams, tests/probe_h264_8x8.py)."""
    v = vmat8(qp) << 4
    if qp >= 36:
        return (c * v) << (qp // 6 - 6)
    return (c * v + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def itransform8(d: np.ndarray) -> np.ndarray:
    """Inverse 8x8 transform (8.5.13.2), rows then columns, WITHOUT the
    final (x + 32) >> 6."""
    def pass1(x):
        # x is [8, n]: one butterfly over axis 0
        e = [None] * 8
        e[0] = x[0] + x[4]
        e[1] = -x[3] + x[5] - x[7] - (x[7] >> 1)
        e[2] = x[0] - x[4]
        e[3] = x[1] + x[7] - x[3] - (x[3] >> 1)
        e[4] = (x[2] >> 1) - x[6]
        e[5] = -x[1] + x[7] + x[5] + (x[5] >> 1)
        e[6] = x[2] + (x[6] >> 1)
        e[7] = x[3] + x[5] + x[1] + (x[1] >> 1)
        f = [None] * 8
        f[0] = e[0] + e[6]
        f[1] = e[1] + (e[7] >> 2)
        f[2] = e[2] + e[4]
        f[3] = e[3] + (e[5] >> 2)
        f[4] = e[2] - e[4]
        f[5] = (e[3] >> 2) - e[5]
        f[6] = e[0] - e[6]
        f[7] = e[7] - (e[1] >> 2)
        return np.stack([f[0] + f[7], f[2] + f[5], f[4] + f[3], f[6] + f[1],
                         f[6] - f[1], f[4] - f[3], f[2] - f[5], f[0] - f[7]])

    h = pass1(d.T).T  # horizontal (each row) first — observable in LSBs
    return pass1(h)   # then vertical


def filter_refs8(top: Optional[np.ndarray], left: Optional[np.ndarray],
                 tl: Optional[int]):
    """Reference-sample filtering for Intra_8x8 (8.3.2.2.1).

    ``top`` is p[0..15, -1] with unavailable top-right already replicated
    from p[7, -1] by the caller; ``left`` is p[-1, 0..7]; ``tl`` is
    p[-1, -1] or None.  Returns (top', left', tl') filtered."""
    ft = fl = None
    ftl = None
    if top is not None:
        t = top.astype(np.int64)
        ft = np.empty(16, np.int64)
        if tl is not None:
            ft[0] = (tl + 2 * t[0] + t[1] + 2) >> 2
        else:
            ft[0] = (3 * t[0] + t[1] + 2) >> 2
        ft[1:15] = (t[0:14] + 2 * t[1:15] + t[2:16] + 2) >> 2
        ft[15] = (t[14] + 3 * t[15] + 2) >> 2
    if left is not None:
        l = left.astype(np.int64)
        fl = np.empty(8, np.int64)
        if tl is not None:
            fl[0] = (tl + 2 * l[0] + l[1] + 2) >> 2
        else:
            fl[0] = (3 * l[0] + l[1] + 2) >> 2
        fl[1:7] = (l[0:6] + 2 * l[1:7] + l[2:8] + 2) >> 2
        fl[7] = (l[6] + 3 * l[7] + 2) >> 2
    if tl is not None:
        if top is not None and left is not None:
            ftl = (int(top[0]) + 2 * tl + int(left[0]) + 2) >> 2
        elif top is not None:
            ftl = (3 * tl + int(top[0]) + 2) >> 2
        elif left is not None:
            ftl = (3 * tl + int(left[0]) + 2) >> 2
        else:
            ftl = tl
    return ft, fl, ftl


def pred8x8(mode: int, t: Optional[np.ndarray], l: Optional[np.ndarray],
            tl: Optional[int]) -> np.ndarray:
    """Intra_8x8 prediction (8.3.2.2.2-.2.10) from FILTERED references.
    ``t``: p'[0..15, -1], ``l``: p'[-1, 0..7], ``tl``: p'[-1, -1]."""
    from ultragrid_tpu_torch.ops.h264_dec import UnsupportedStream

    p = np.zeros((8, 8), np.int64)
    if mode == 0:  # Vertical
        p[:] = t[None, :8]
    elif mode == 1:  # Horizontal
        p[:] = l[:, None]
    elif mode == 2:  # DC
        if t is not None and l is not None:
            p[:] = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
        elif t is not None:
            p[:] = (int(t[:8].sum()) + 4) >> 3
        elif l is not None:
            p[:] = (int(l.sum()) + 4) >> 3
        else:
            p[:] = 128
    elif mode == 3:  # Diagonal-Down-Left
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    p[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    p[y, x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
    elif mode == 4:  # Diagonal-Down-Right
        def T4(i):
            return tl if i == -1 else t[i]

        def L4(i):
            return tl if i == -1 else l[i]
        for y in range(8):
            for x in range(8):
                if x > y:
                    p[y, x] = (T4(x - y - 2) + 2 * T4(x - y - 1) + t[x - y] + 2) >> 2
                elif x < y:
                    p[y, x] = (L4(y - x - 2) + 2 * L4(y - x - 1) + l[y - x] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * tl + l[0] + 2) >> 2
    elif mode == 5:  # Vertical-Right
        def T(i):
            return tl if i == -1 else t[i]
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (T(x - (y >> 1) - 1) + T(x - (y >> 1)) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (T(x - (y >> 1) - 2) + 2 * T(x - (y >> 1) - 1)
                               + T(x - (y >> 1)) + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    def L(i):
                        return tl if i == -1 else l[i]
                    p[y, x] = (L(y - 2 * x - 1) + 2 * L(y - 2 * x - 2)
                               + L(y - 2 * x - 3) + 2) >> 2
    elif mode == 6:  # Horizontal-Down
        def L(i):
            return tl if i == -1 else l[i]
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (L(y - (x >> 1) - 1) + L(y - (x >> 1)) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (L(y - (x >> 1) - 2) + 2 * L(y - (x >> 1) - 1)
                               + L(y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    def T(i):
                        return tl if i == -1 else t[i]
                    p[y, x] = (T(x - 2 * y - 1) + 2 * T(x - 2 * y - 2)
                               + T(x - 2 * y - 3) + 2) >> 2
    elif mode == 7:  # Vertical-Left
        for y in range(8):
            for x in range(8):
                if y % 2 == 0:
                    p[y, x] = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1
                else:
                    p[y, x] = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                               + t[x + (y >> 1) + 2] + 2) >> 2
    elif mode == 8:  # Horizontal-Up
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z < 13 and z % 2 == 0:
                    p[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1
                elif z < 13:
                    p[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                               + l[y + (x >> 1) + 2] + 2) >> 2
                elif z == 13:
                    p[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    p[y, x] = l[7]
    else:
        raise UnsupportedStream(f"intra8x8 mode {mode}")
    return p


def recon_res8(zz64: np.ndarray, qp: int) -> np.ndarray:
    """Zig-zag 64-coefficient array -> spatial residual (8x8)."""
    d = dequant8(dezigzag8(zz64), qp)
    return (itransform8(d) + 32) >> 6


# CABAC ctxIdxInc maps for ctxBlockCat 5, frame-coded (Table 9-43):
# scan position -> increment for significant_coeff_flag / last_..._flag.
# Both tables byte-verified against the system libx264/libavcodec rodata
# (ultragrid_tpu/tools/extract_cabac_tables.py finds them adjacent in
# both binaries) — the spec's published trained constants, not code.
SIG8_INC = np.array([
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12,
], np.int64)
LAST8_INC = np.array([
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8,
], np.int64)
