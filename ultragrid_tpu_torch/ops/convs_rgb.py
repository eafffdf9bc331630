"""RGB-family pixel format conversions (RGB/RGBA/BGR/R10k/R12L/RG48/VUYA) on
tensors.

Port of ``ultragrid_tpu/ops/convs_rgb.py``: bit-exact re-derivations of the reference line converters (cited per function;
all in src/pixfmt_conv.c).  R12L is treated as plain LSB-first 12-bit packing
(SMPTE 268M DPX Method C4); R10k as big-endian RGB 10+2 (ref: types.h / the
bitfield structs in pixfmt_conv.c:214-227,2544-2557).
"""

from __future__ import annotations

import torch

from ultragrid_tpu_torch.ops._kutils import (
    cdiv2,
    dfl_coeffs,
    groups,
    le16,
    pack_bytes,
    rgb_to_cb,
    rgb_to_cr,
    rgb_to_y,
    shr,
    split16,
)
from ultragrid_tpu_torch.ops.color import COMP_BASE
from ultragrid_tpu_torch.ops.pixfmt import register
from ultragrid_tpu_torch.types import Codec

C = Codec


# ---------------------------------------------------------------------------
# byte shuffles among RGB formats
# ---------------------------------------------------------------------------


@register(C.RGB, C.RGBA)
def rgb_to_rgba(src, width):
    """ref: vc_copylineRGBtoRGBA, pixfmt_conv.c:944 (default shifts, A=0xFF)."""
    g = groups(src, 3)
    return pack_bytes(g[..., 0], g[..., 1], g[..., 2], torch.full_like(g[..., 0], 0xFF))


@register(C.RGBA, C.RGB)
def rgba_to_rgb(src, width):
    """ref: vc_copylineRGBAtoRGB, pixfmt_conv.c:866."""
    g = groups(src, 4)
    return pack_bytes(g[..., 0], g[..., 1], g[..., 2])


@register(C.BGR, C.RGB)
def bgr_to_rgb(src, width):
    """ref: vc_copylineBGRtoRGB, pixfmt_conv.c:2520."""
    g = groups(src, 3)
    return pack_bytes(g[..., 2], g[..., 1], g[..., 0])


@register(C.RGBA, C.RG48)
def rgba_to_rg48(src, width):
    """ref: vc_copylineRGBAtoRG48, pixfmt_conv.c:1336 (8-bit into high byte)."""
    g = groups(src, 4)
    z = torch.zeros_like(g[..., 0])
    return pack_bytes(z, g[..., 0], z, g[..., 1], z, g[..., 2])


@register(C.RGB, C.RG48)
def rgb_to_rg48(src, width):
    """ref: vc_copylineRGBtoRG48, pixfmt_conv.c:1353."""
    g = groups(src, 1)
    z = torch.zeros_like(g[..., 0])
    return pack_bytes(z, g[..., 0])


@register(C.RG48, C.RGB)
def rg48_to_rgb(src, width):
    """ref: vc_copylineRG48toRGB, pixfmt_conv.c:2031 (high bytes)."""
    g = groups(src, 6)
    return pack_bytes(g[..., 1], g[..., 3], g[..., 5])


@register(C.RG48, C.RGBA)
def rg48_to_rgba(src, width):
    """ref: vc_copylineRG48toRGBA, pixfmt_conv.c:2045."""
    g = groups(src, 6)
    return pack_bytes(g[..., 1], g[..., 3], g[..., 5], torch.full_like(g[..., 0], 0xFF))


# ---------------------------------------------------------------------------
# RGB(ish) -> UYVY (DEPTH8 coefficients; ref: vc_copylineToUYVY :1008-1053)
# ---------------------------------------------------------------------------


def _pairs_to_uyvy(r1, g1, b1, r2, g2, b2):
    cfs = dfl_coeffs(8)
    y1 = shr(rgb_to_y(cfs, r1, g1, b1), COMP_BASE) + 16
    y2 = shr(rgb_to_y(cfs, r2, g2, b2), COMP_BASE) + 16
    u = rgb_to_cb(cfs, r1, g1, b1) + rgb_to_cb(cfs, r2, g2, b2)
    v = rgb_to_cr(cfs, r1, g1, b1) + rgb_to_cr(cfs, r2, g2, b2)
    u = shr(cdiv2(u), COMP_BASE) + 128
    v = shr(cdiv2(v), COMP_BASE) + 128
    return pack_bytes(u, y1, v, y2)


def _rgbish_to_uyvy(src, roff, goff, boff, pix_size):
    g = groups(src, 2 * pix_size)
    return _pairs_to_uyvy(
        g[..., roff], g[..., goff], g[..., boff],
        g[..., pix_size + roff], g[..., pix_size + goff], g[..., pix_size + boff],
    )


@register(C.RGB, C.UYVY)
def rgb_to_uyvy(src, width):
    """ref: vc_copylineRGBtoUYVY, pixfmt_conv.c:2061."""
    return _rgbish_to_uyvy(src, 0, 1, 2, 3)


@register(C.BGR, C.UYVY)
def bgr_to_uyvy(src, width):
    """ref: vc_copylineBGRtoUYVY, pixfmt_conv.c:2271."""
    return _rgbish_to_uyvy(src, 2, 1, 0, 3)


@register(C.RGBA, C.UYVY)
def rgba_to_uyvy(src, width):
    """ref: vc_copylineRGBAtoUYVY, pixfmt_conv.c:2311."""
    return _rgbish_to_uyvy(src, 0, 1, 2, 4)


@register(C.RG48, C.UYVY)
def rg48_to_uyvy(src, width):
    """ref: vc_copylineRG48toUYVY, pixfmt_conv.c:2342 (high bytes as 8-bit)."""
    return _rgbish_to_uyvy(src, 1, 3, 5, 6)


@register(C.R10k, C.UYVY)
def r10k_to_uyvy(src, width):
    """ref: vc_copylineR10ktoUYVY, pixfmt_conv.c:2320 (8-bit unpack first)."""
    g = groups(src, 8)

    def comp8(o):
        r = g[..., o + 0]
        gg = ((g[..., o + 1] << 2) | shr(g[..., o + 2], 6)) & 0xFF
        b = ((g[..., o + 2] << 4) | shr(g[..., o + 3], 4)) & 0xFF
        return r, gg, b

    r1, g1, b1 = comp8(0)
    r2, g2, b2 = comp8(4)
    return _pairs_to_uyvy(r1, g1, b1, r2, g2, b2)


@register(C.RGBA, C.VUYA)
def rgba_to_vuya(src, width):
    """ref: vc_copylineRGBAtoVUYA, pixfmt_conv.c:2280."""
    cfs = dfl_coeffs(8)
    g = groups(src, 4)
    r, gg, b, a = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    cr = shr(rgb_to_cr(cfs, r, gg, b), COMP_BASE) + 128
    cb = shr(rgb_to_cb(cfs, r, gg, b), COMP_BASE) + 128
    y = shr(rgb_to_y(cfs, r, gg, b), COMP_BASE) + 16
    return pack_bytes(cr, cb, y, a)


# ---------------------------------------------------------------------------
# R10k (big-endian 10-bit RGB + 2 pad bits)
# ---------------------------------------------------------------------------


def _r10k_comps16(g):
    """Full-precision 16-bit-scale components (ref: r10ktoY416 :297-329)."""
    r = (g[..., 0] << 8) | (g[..., 1] & 0xC0)
    gg = ((g[..., 1] & 0x3F) << 10) | ((g[..., 2] & 0xF0) << 2)
    b = ((g[..., 2] & 0xF) << 12) | ((g[..., 3] & 0xFC) << 4)
    return r, gg, b


@register(C.R10k, C.RGBA)
def r10k_to_rgba(src, width):
    """ref: vc_copyliner10k, pixfmt_conv.c:210 (top 8 bits, A=0xFF)."""
    g = groups(src, 4)
    r = g[..., 0]
    gg = ((g[..., 1] << 2) | shr(g[..., 2], 6)) & 0xFF
    b = ((g[..., 2] << 4) | shr(g[..., 3], 4)) & 0xFF
    return pack_bytes(r, gg, b, torch.full_like(r, 0xFF))


@register(C.R10k, C.RGB)
def r10k_to_rgb(src, width):
    """ref: vc_copyliner10ktoRGB, pixfmt_conv.c:331."""
    g = groups(src, 4)
    r = g[..., 0]
    gg = ((g[..., 1] << 2) | shr(g[..., 2], 6)) & 0xFF
    b = ((g[..., 2] << 4) | shr(g[..., 3], 4)) & 0xFF
    return pack_bytes(r, gg, b)


@register(C.R10k, C.RG48)
def r10k_to_rg48(src, width):
    """ref: vc_copyliner10ktoRG48, pixfmt_conv.c:278."""
    g = groups(src, 4)
    rhi = g[..., 0]
    rlo = g[..., 1] & 0xC0
    ghi = ((g[..., 1] << 2) | shr(g[..., 2], 6)) & 0xFF
    glo = (g[..., 2] & 0x30) << 2
    bhi = ((g[..., 2] & 0xF) << 4) | shr(g[..., 3], 4)
    blo = (g[..., 3] & 0xC) << 4
    return pack_bytes(rlo, rhi, glo & 0xFF, ghi, blo & 0xFF, bhi)


@register(C.R10k, C.Y416)
def r10k_to_y416(src, width):
    """ref: vc_copyliner10ktoY416, pixfmt_conv.c:297 (no clamping)."""
    cfs = dfl_coeffs(16)
    g = groups(src, 4)
    r, gg, b = _r10k_comps16(g)
    u = shr(rgb_to_cb(cfs, r, gg, b), COMP_BASE) + (1 << 15)
    y = shr(rgb_to_y(cfs, r, gg, b), COMP_BASE) + (1 << 12)
    v = shr(rgb_to_cr(cfs, r, gg, b), COMP_BASE) + (1 << 15)
    out = []
    for val in (u, y, v):
        lo, hi = split16(val)
        out += [lo, hi]
    ff = torch.full_like(u, 0xFF)
    return pack_bytes(*out, ff, ff)


@register(C.RGBA, C.R10k)
def rgba_to_r10k(src, width):
    """ref: vc_copylineRGBAtoR10k, pixfmt_conv.c:2538 (pad p3=0x3)."""
    g = groups(src, 4)
    r, gg, b = g[..., 0], g[..., 1], g[..., 2]
    return pack_bytes(
        r,
        shr(gg, 2),
        shr(b, 4) | ((gg & 0x3) << 6),
        0x3 | ((b & 0xF) << 4),
    )


@register(C.RG48, C.R10k)
def rg48_to_r10k(src, width):
    """ref: vc_copylineRG48toR10k, pixfmt_conv.c:2008."""
    g = groups(src, 6)
    r = shr(le16(g[..., 0:2]), 6)
    gg = shr(le16(g[..., 2:4]), 6)
    b = shr(le16(g[..., 4:6]), 6)
    return pack_bytes(
        shr(r, 2),
        ((r & 0x3) << 6) | shr(gg, 4),
        ((gg & 0xF) << 4) | shr(b, 6),
        ((b & 0x3F) << 2) | 0x3,
    )


# ---------------------------------------------------------------------------
# R12L (LSB-first 12-bit packed RGB, 8 px / 36 B)
# ---------------------------------------------------------------------------


def unpack_r12l(src):
    """[H, L] -> (r12, g12, b12) each [H, npix] int32 (LSB-first unpack)."""
    g = groups(src, 3)  # 3 bytes -> 2 12-bit values
    v0 = g[..., 0] | ((g[..., 1] & 0xF) << 8)
    v1 = shr(g[..., 1], 4) | (g[..., 2] << 4)
    vals = torch.stack([v0, v1], dim=-1).reshape(src.shape[0], -1)  # [H, nvals]
    h, n = vals.shape
    rgb = vals.reshape(h, n // 3, 3)
    return rgb[..., 0], rgb[..., 1], rgb[..., 2]


def pack_r12l(r12, g12, b12):
    """(r, g, b) [H, npix] 12-bit -> [H, npix*36//8] uint8 (LSB-first)."""
    h = r12.shape[0]
    vals = torch.stack([r12, g12, b12], dim=-1).reshape(h, -1)  # [H, nvals]
    n = vals.shape[1]
    pairs = vals[:, : (n // 2) * 2].reshape(h, n // 2, 2)
    v0, v1 = pairs[..., 0] & 0xFFF, pairs[..., 1] & 0xFFF
    return pack_bytes(v0 & 0xFF, shr(v0, 8) | ((v1 & 0xF) << 4), shr(v1, 4))


@register(C.R12L, C.RG48)
def r12l_to_rg48(src, width):
    """ref: vc_copylineR12LtoRG48, pixfmt_conv.c:1371 (v16 = v12 << 4)."""
    r, g, b = unpack_r12l(src)
    out = []
    for v in (r, g, b):
        lo, hi = split16(v << 4)
        out += [lo, hi]
    return pack_bytes(*out)


@register(C.R12L, C.RGB)
def r12l_to_rgb(src, width):
    """ref: vc_copylineR12LtoRGB, pixfmt_conv.c:352 (top 8 bits)."""
    r, g, b = unpack_r12l(src)
    return pack_bytes(shr(r, 4), shr(g, 4), shr(b, 4))


@register(C.R12L, C.RGBA)
def r12l_to_rgba(src, width):
    """ref: vc_copylineR12L, pixfmt_conv.c:437."""
    r, g, b = unpack_r12l(src)
    return pack_bytes(shr(r, 4), shr(g, 4), shr(b, 4), torch.full_like(r, 0xFF))


@register(C.R12L, C.R10k)
def r12l_to_r10k(src, width):
    """ref: vc_copylineR12LtoR10k, pixfmt_conv.c:1640.

    Exact replica including two reference quirks: the low 2 bits of b12 land
    in the R10k pad bits, and for pixel index % 8 == 1 the last byte's low
    nibble comes from r12 (pixfmt_conv.c:1659 uses src[4+0] where the pattern
    elsewhere uses the blue byte).
    """
    r, g, b = unpack_r12l(src)
    byte3 = b & 0xFF
    idx = torch.arange(r.shape[1], device=r.device)[None, :]
    byte3 = torch.where((idx % 8) == 1, (b & 0xF0) | (r & 0xF), byte3)
    return pack_bytes(
        shr(r, 4),
        ((r & 0xC) << 4) | shr(g, 6),
        ((shr(g, 2) & 0xF) << 4) | shr(b, 8),
        byte3,
    )


@register(C.R12L, C.Y416)
def r12l_to_y416(src, width):
    """ref: vc_copylineR12LtoY416, pixfmt_conv.c:1478 (DEPTH16 coeffs)."""
    cfs = dfl_coeffs(16)
    r, g, b = unpack_r12l(src)
    r, g, b = r << 4, g << 4, b << 4
    u = shr(rgb_to_cb(cfs, r, g, b), COMP_BASE) + (1 << 15)
    y = shr(rgb_to_y(cfs, r, g, b), COMP_BASE) + (1 << 12)
    v = shr(rgb_to_cr(cfs, r, g, b), COMP_BASE) + (1 << 15)
    out = []
    for val in (u, y, v):
        lo, hi = split16(val)
        out += [lo, hi]
    ff = torch.full_like(u, 0xFF)
    return pack_bytes(*out, ff, ff)


@register(C.R12L, C.UYVY)
def r12l_to_uyvy(src, width):
    """ref: vc_copylineR12LtoUYVY, pixfmt_conv.c:1543.

    16-bit-scale RGB through DEPTH8 coefficients; chroma averaged by an extra
    arithmetic shift (not C division).
    """
    cfs = dfl_coeffs(8)
    r, g, b = unpack_r12l(src)
    r, g, b = r << 4, g << 4, b << 4
    h, n = r.shape
    rp = r.reshape(h, n // 2, 2)
    gp = g.reshape(h, n // 2, 2)
    bp = b.reshape(h, n // 2, 2)
    r1, r2 = rp[..., 0], rp[..., 1]
    g1, g2 = gp[..., 0], gp[..., 1]
    b1, b2 = bp[..., 0], bp[..., 1]
    u = shr(rgb_to_cb(cfs, r1, g1, b1) + rgb_to_cb(cfs, r2, g2, b2), COMP_BASE + 8 + 1) + 128
    y1 = shr(rgb_to_y(cfs, r1, g1, b1), COMP_BASE + 8) + 16
    v = shr(rgb_to_cr(cfs, r1, g1, b1) + rgb_to_cr(cfs, r2, g2, b2), COMP_BASE + 8 + 1) + 128
    y2 = shr(rgb_to_y(cfs, r2, g2, b2), COMP_BASE + 8) + 16
    return pack_bytes(u, y1, v, y2)


@register(C.RGB, C.R12L)
def rgb_to_r12l(src, width):
    """ref: vc_copylineRGBtoR12L -> vc_copylineRGB_AtoR12L, pixfmt_conv.c:1263."""
    g = groups(src, 3)
    return pack_r12l(g[..., 0] << 4, g[..., 1] << 4, g[..., 2] << 4)


@register(C.RGBA, C.R12L)
def rgba_to_r12l(src, width):
    """ref: vc_copylineRGBAtoR12L, pixfmt_conv.c:1330."""
    g = groups(src, 4)
    return pack_r12l(g[..., 0] << 4, g[..., 1] << 4, g[..., 2] << 4)


@register(C.RG48, C.R12L)
def rg48_to_r12l(src, width):
    """ref: vc_copylineRG48toR12L, pixfmt_conv.c:1701 (v12 = v16 >> 4)."""
    g = groups(src, 6)
    r = shr(le16(g[..., 0:2]), 4)
    gg = shr(le16(g[..., 2:4]), 4)
    b = shr(le16(g[..., 4:6]), 4)
    return pack_r12l(r, gg, b)


# ---------------------------------------------------------------------------
# RG48 -> packed YCbCr
# ---------------------------------------------------------------------------


@register(C.RG48, C.v210)
def rg48_to_v210(src, width):
    """ref: vc_copylineRG48toV210, pixfmt_conv.c:2354 (DEPTH10 coeffs,
    per-term shift before chroma sum, C division by 2)."""
    cfs = dfl_coeffs(10)
    off = COMP_BASE + 6
    g = groups(src, 12)  # 2 px
    r1, g1, b1 = le16(g[..., 0:2]), le16(g[..., 2:4]), le16(g[..., 4:6])
    r2, g2, b2 = le16(g[..., 6:8]), le16(g[..., 8:10]), le16(g[..., 10:12])
    y1 = shr(rgb_to_y(cfs, r1, g1, b1), off) + (1 << 6)
    y2 = shr(rgb_to_y(cfs, r2, g2, b2), off) + (1 << 6)
    u = shr(rgb_to_cb(cfs, r1, g1, b1), off) + shr(rgb_to_cb(cfs, r2, g2, b2), off)
    v = shr(rgb_to_cr(cfs, r1, g1, b1), off) + shr(rgb_to_cr(cfs, r2, g2, b2), off)
    u = cdiv2(u) + (1 << 9)
    v = cdiv2(v) + (1 << 9)
    # regroup pairs into 6-px v210 blocks
    h, npairs = y1.shape
    nblk = npairs // 3
    def blk(x):
        return x[:, : nblk * 3].reshape(h, nblk, 3)
    y1b, y2b, ub, vb = blk(y1), blk(y2), blk(u), blk(v)
    from ultragrid_tpu_torch.ops.convs_yuv import _pack_v210_words

    return _pack_v210_words(
        [
            (ub[..., 0], y1b[..., 0], vb[..., 0]),
            (y2b[..., 0], ub[..., 1], y1b[..., 1]),
            (vb[..., 1], y2b[..., 1], ub[..., 2]),
            (y1b[..., 2], vb[..., 2], y2b[..., 2]),
        ]
    )


@register(C.RG48, C.Y216)
def rg48_to_y216(src, width):
    """ref: vc_copylineRG48toY216, pixfmt_conv.c:2410."""
    cfs = dfl_coeffs(16)
    g = groups(src, 12)
    r1, g1, b1 = le16(g[..., 0:2]), le16(g[..., 2:4]), le16(g[..., 4:6])
    r2, g2, b2 = le16(g[..., 6:8]), le16(g[..., 8:10]), le16(g[..., 10:12])
    y1 = shr(rgb_to_y(cfs, r1, g1, b1), COMP_BASE) + (1 << 12)
    u = cdiv2(shr(rgb_to_cb(cfs, r1, g1, b1), COMP_BASE) + shr(rgb_to_cb(cfs, r2, g2, b2), COMP_BASE)) + (1 << 15)
    y2 = shr(rgb_to_y(cfs, r2, g2, b2), COMP_BASE) + (1 << 12)
    v = cdiv2(shr(rgb_to_cr(cfs, r1, g1, b1), COMP_BASE) + shr(rgb_to_cr(cfs, r2, g2, b2), COMP_BASE)) + (1 << 15)
    out = []
    for val in (y1, u, y2, v):
        lo, hi = split16(val)
        out += [lo, hi]
    return pack_bytes(*out)


@register(C.RG48, C.Y416)
def rg48_to_y416(src, width):
    """ref: vc_copylineRG48toY416, pixfmt_conv.c:2451."""
    cfs = dfl_coeffs(16)
    g = groups(src, 6)
    r, gg, b = le16(g[..., 0:2]), le16(g[..., 2:4]), le16(g[..., 4:6])
    u = shr(rgb_to_cb(cfs, r, gg, b), COMP_BASE) + (1 << 15)
    y = shr(rgb_to_y(cfs, r, gg, b), COMP_BASE) + (1 << 12)
    v = shr(rgb_to_cr(cfs, r, gg, b), COMP_BASE) + (1 << 15)
    out = []
    for val in (u, y, v):
        lo, hi = split16(val)
        out += [lo, hi]
    ff = torch.full_like(u, 0xFF)
    return pack_bytes(*out, ff, ff)
