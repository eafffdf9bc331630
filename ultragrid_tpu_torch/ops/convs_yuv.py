"""Packed-YUV pixel format conversions (UYVY/YUYV/v210/Y216/Y416/VUYA/DVS10)
on tensors.

Port of ``ultragrid_tpu/ops/convs_yuv.py``: each function is bit-exact with
the corresponding reference line converter (cited per function; all in
src/pixfmt_conv.c).  Frames are uint8 ``[H, linesize]``; math is int32 with
arithmetic shifts; 32-bit words (v210, DVS10) are int64.
"""

from __future__ import annotations

import torch

from ultragrid_tpu_torch.ops._kutils import (
    clamp,
    clamp_full,
    dfl_coeffs,
    groups,
    le16,
    pack_bytes,
    shr,
    split16,
    u32_to_bytes,
    words_u32,
    ycbcr_to_b,
    ycbcr_to_g,
    ycbcr_to_r,
)
from ultragrid_tpu_torch.ops.color import COMP_BASE
from ultragrid_tpu_torch.ops.pixfmt import register
from ultragrid_tpu_torch.types import Codec

C = Codec


# ---------------------------------------------------------------------------
# byte shuffles
# ---------------------------------------------------------------------------


@register(C.YUYV, C.UYVY)
@register(C.UYVY, C.YUYV)
def uyvy_yuyv_swap(src: torch.Tensor, width: int) -> torch.Tensor:
    """Swap luma/chroma byte positions (ref: vc_copylineYUYV, pixfmt_conv.c:136)."""
    g = groups(src, 2)
    return pack_bytes(g[..., 1], g[..., 0])


# ---------------------------------------------------------------------------
# YCbCr 4:2:2 8-bit <-> RGB (DEPTH8 coefficients)
# ---------------------------------------------------------------------------


def _yuv422_to_rgb(y1, y2, u, v, rgb16: bool):
    """ref: copylineYUVtoRGB macro, pixfmt_conv.c:1065-1094 (CLAMP 0..255)."""
    cfs = dfl_coeffs(8)
    ys1 = cfs.y_scale * (y1 - 16)
    ys2 = cfs.y_scale * (y2 - 16)
    u = u - 128
    v = v - 128
    out = []
    for ys in (ys1, ys2):
        r = clamp(shr(ycbcr_to_r(cfs, ys, u, v), COMP_BASE), 0, 255)
        g = clamp(shr(ycbcr_to_g(cfs, ys, u, v), COMP_BASE), 0, 255)
        b = clamp(shr(ycbcr_to_b(cfs, ys, u, v), COMP_BASE), 0, 255)
        if rgb16:
            out += [torch.zeros_like(r), r, torch.zeros_like(g), g, torch.zeros_like(b), b]
        else:
            out += [r, g, b]
    return out


@register(C.UYVY, C.RGB)
def uyvy_to_rgb(src, width):
    """ref: vc_copylineUYVYtoRGB, pixfmt_conv.c:1102."""
    g = groups(src, 4)
    return pack_bytes(*_yuv422_to_rgb(g[..., 1], g[..., 3], g[..., 0], g[..., 2], False))


@register(C.YUYV, C.RGB)
def yuyv_to_rgb(src, width):
    """ref: vc_copylineYUYVtoRGB, pixfmt_conv.c:1116."""
    g = groups(src, 4)
    return pack_bytes(*_yuv422_to_rgb(g[..., 0], g[..., 2], g[..., 1], g[..., 3], False))


@register(C.UYVY, C.RG48)
def uyvy_to_rg48(src, width):
    """ref: vc_copylineUYVYtoRG48, pixfmt_conv.c:1124."""
    g = groups(src, 4)
    return pack_bytes(*_yuv422_to_rgb(g[..., 1], g[..., 3], g[..., 0], g[..., 2], True))


@register(C.UYVY, C.RGBA)
def uyvy_to_rgba(src, width):
    """UYVY -> RGBA, alpha 0xFF.

    The reference implementation (vc_copylineUYVYtoRGBA, pixfmt_conv.c:1137)
    uses C double-arithmetic BT.709 constants; we use the equivalent
    fixed-point path of vc_copylineUYVYtoRGB (same coefficients at 14-bit
    scale), which may differ by at most 1 LSB in rare cases.
    """
    g = groups(src, 4)
    r1, g1, b1, r2, g2, b2 = _yuv422_to_rgb(g[..., 1], g[..., 3], g[..., 0], g[..., 2], False)
    a = torch.full_like(r1, 0xFF)
    return pack_bytes(r1, g1, b1, a, r2, g2, b2, a)


# ---------------------------------------------------------------------------
# v210 (10-bit 4:2:2; LE 32-bit words of three 10-bit fields, ref: types.h:73)
# ---------------------------------------------------------------------------


def _v210_fields(src):
    """[H, L] -> (a, b, c) int32 fields per word [H, W]."""
    w = words_u32(src)
    a = (w & 0x3FF).to(torch.int32)
    b = ((w >> 10) & 0x3FF).to(torch.int32)
    c = ((w >> 20) & 0x3FF).to(torch.int32)
    return a, b, c


def _v210_components(src):
    """Per 4-word group: u01 y0 v01 | y1 u23 y2 | v23 y3 u45 | y4 v45 y5."""
    a, b, c = _v210_fields(src)
    h, w = a.shape
    g = w // 4
    a = a[:, : g * 4].reshape(h, g, 4)
    b = b[:, : g * 4].reshape(h, g, 4)
    c = c[:, : g * 4].reshape(h, g, 4)
    u01, y0, v01 = a[..., 0], b[..., 0], c[..., 0]
    y1, u23, y2 = a[..., 1], b[..., 1], c[..., 1]
    v23, y3, u45 = a[..., 2], b[..., 2], c[..., 2]
    y4, v45, y5 = a[..., 3], b[..., 3], c[..., 3]
    return (y0, y1, y2, y3, y4, y5), (u01, u23, u45), (v01, v23, v45)


def _pack_v210_words(vals3):
    """List of (a, b, c) triples -> uint8 bytes; fields already 10-bit."""
    ws = [
        (a.to(torch.int64) & 0x3FF)
        | ((b.to(torch.int64) & 0x3FF) << 10)
        | ((c.to(torch.int64) & 0x3FF) << 20)
        for a, b, c in vals3
    ]
    w = torch.stack(ws, dim=-1)  # [H, G, 4]
    return u32_to_bytes(w.reshape(w.shape[0], -1))


@register(C.v210, C.UYVY)
def v210_to_uyvy(src, width):
    """ref: vc_copylinev210, pixfmt_conv.c:86 (take top 8 of each 10)."""
    a, b, c = _v210_fields(src)
    return pack_bytes(shr(a, 2), shr(b, 2), shr(c, 2))


@register(C.UYVY, C.v210)
def uyvy_to_v210(src, width):
    """ref: vc_copylineUYVYtoV210, pixfmt_conv.c:2581 (8-bit << 2)."""
    g = groups(src, 3)
    return _pack_v210_words([(g[..., 0] << 2, g[..., 1] << 2, g[..., 2] << 2)])


@register(C.v210, C.Y216)
def v210_to_y216(src, width):
    """ref: vc_copylineV210toY216, pixfmt_conv.c:2792 (fields << 6, YUYV order)."""
    (y0, y1, y2, y3, y4, y5), (u01, u23, u45), (v01, v23, v45) = _v210_components(src)
    vals = [y0, u01, y1, v01, y2, u23, y3, v23, y4, u45, y5, v45]
    out = []
    for v in vals:
        lo, hi = split16(v << 6)
        out += [lo, hi]
    return pack_bytes(*out)


@register(C.Y216, C.v210)
def y216_to_v210(src, width):
    """ref: vc_copylineY216toV210, pixfmt_conv.c:2761 (>> 6)."""
    g = groups(src, 24)  # 6 px: Y U Y V x3 16-bit LE
    s = [le16(g[..., 2 * i : 2 * i + 2]) for i in range(12)]
    y0, u01, y1, v01, y2, u23, y3, v23, y4, u45, y5, v45 = s
    t = lambda x: shr(x, 6)
    return _pack_v210_words(
        [
            (t(u01), t(y0), t(v01)),
            (t(y1), t(u23), t(y2)),
            (t(v23), t(y3), t(u45)),
            (t(y4), t(v45), t(y5)),
        ]
    )


@register(C.v210, C.Y416)
def v210_to_y416(src, width):
    """ref: vc_copylineV210toY416, pixfmt_conv.c:2834 (U Y V A, chroma dup)."""
    (y0, y1, y2, y3, y4, y5), (u01, u23, u45), (v01, v23, v45) = _v210_components(src)
    out = []
    a16 = None
    for y, u, v in ((y0, u01, v01), (y1, u01, v01), (y2, u23, v23), (y3, u23, v23), (y4, u45, v45), (y5, u45, v45)):
        for val in (u << 6, y << 6, v << 6):
            lo, hi = split16(val)
            out += [lo, hi]
        if a16 is None:
            a16 = torch.full_like(y, 0xFF)
        out += [a16, a16]
    return pack_bytes(*out)


def _v210_to_rgbish(src, idepth: int, odepth: int):
    """ref: vc_copylineV210toRGB :2884 (8-bit cherry-pick) / toRG48 :2942."""
    cfs = dfl_coeffs(idepth)
    (ys), (us), (vs) = _v210_components(src)
    drop = 10 - idepth  # components read at idepth precision
    c_shift = 1 << (idepth - 1)
    y_shift = 1 << (idepth - 4)
    shift_out = COMP_BASE - (odepth - idepth)
    outs = []
    pair = [(0, 0), (1, 0), (2, 1), (3, 1), (4, 2), (5, 2)]
    ys6 = ys
    for yi, ci in pair:
        y = shr(ys6[yi], drop) if drop else ys6[yi]
        u = (shr(us[ci], drop) if drop else us[ci]) - c_shift
        v = (shr(vs[ci], drop) if drop else vs[ci]) - c_shift
        ysc = cfs.y_scale * (y - y_shift)
        r = clamp_full(shr(ycbcr_to_r(cfs, ysc, u, v), shift_out), odepth)
        g = clamp_full(shr(ycbcr_to_g(cfs, ysc, u, v), shift_out), odepth)
        b = clamp_full(shr(ycbcr_to_b(cfs, ysc, u, v), shift_out), odepth)
        outs.append((r, g, b))
    return outs


@register(C.v210, C.RGB)
def v210_to_rgb(src, width):
    """ref: vc_copylineV210toRGB, pixfmt_conv.c:2884."""
    outs = _v210_to_rgbish(src, 8, 8)
    flat = [ch for rgb in outs for ch in rgb]
    return pack_bytes(*flat)


@register(C.v210, C.RG48)
def v210_to_rg48(src, width):
    """ref: vc_copylineV210toRG48, pixfmt_conv.c:2942."""
    outs = _v210_to_rgbish(src, 10, 16)
    flat = []
    for r, g, b in outs:
        for v in (r, g, b):
            lo, hi = split16(v)
            flat += [lo, hi]
    return pack_bytes(*flat)


# ---------------------------------------------------------------------------
# Y216 / Y416 (16-bit packed)
# ---------------------------------------------------------------------------


@register(C.UYVY, C.Y216)
def uyvy_to_y216(src, width):
    """ref: vc_copylineUYVYtoY216, pixfmt_conv.c:2609."""
    g = groups(src, 4)
    z = torch.zeros_like(g[..., 0])
    return pack_bytes(z, g[..., 1], z, g[..., 0], z, g[..., 3], z, g[..., 2])


@register(C.UYVY, C.Y416)
def uyvy_to_y416(src, width):
    """ref: vc_copylineUYVYtoY416, pixfmt_conv.c:2629."""
    g = groups(src, 4)
    z = torch.zeros_like(g[..., 0])
    ff = torch.full_like(g[..., 0], 0xFF)
    u, y0, v, y1 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    return pack_bytes(z, u, z, y0, z, v, ff, ff, z, u, z, y1, z, v, ff, ff)


@register(C.Y216, C.UYVY)
def y216_to_uyvy(src, width):
    """ref: vc_copylineY216toUYVY, pixfmt_conv.c:2729 (high bytes)."""
    g = groups(src, 8)
    return pack_bytes(g[..., 3], g[..., 1], g[..., 7], g[..., 5])


@register(C.Y416, C.UYVY)
def y416_to_uyvy(src, width):
    """ref: vc_copylineY416toUYVY, pixfmt_conv.c:2745 (avg chroma, high bytes)."""
    g = groups(src, 16)
    u = shr(g[..., 1] + g[..., 9], 1)
    v = shr(g[..., 5] + g[..., 13], 1)
    return pack_bytes(u, g[..., 3], v, g[..., 11])


@register(C.Y416, C.v210)
def y416_to_v210(src, width):
    """ref: vc_copylineY416toV210, pixfmt_conv.c:3004."""
    g = groups(src, 48)  # 6 px * 8 B
    s = [le16(g[..., 2 * i : 2 * i + 2]) for i in range(24)]
    t = lambda x: shr(x, 6)
    u01 = shr(s[0] + s[4], 1)
    v01 = shr(s[2] + s[6], 1)
    u23 = shr(s[8] + s[12], 1)
    v23 = shr(s[10] + s[14], 1)
    u45 = shr(s[16] + s[20], 1)
    v45 = shr(s[18] + s[22], 1)
    y0, y1, y2, y3, y4, y5 = s[1], s[5], s[9], s[13], s[17], s[21]
    return _pack_v210_words(
        [
            (t(u01), t(y0), t(v01)),
            (t(y1), t(u23), t(y2)),
            (t(v23), t(y3), t(u45)),
            (t(y4), t(v45), t(y5)),
        ]
    )


def _y416_components(src):
    g = groups(src, 8)
    u = le16(g[..., 0:2])
    y = le16(g[..., 2:4])
    v = le16(g[..., 4:6])
    a = le16(g[..., 6:8])
    return y, u, v, a


def y416_to_rgb_comps(src, odepth: int):
    """Shared Y416 -> full-range RGB at odepth (S_DEPTH=16 coefficients).

    ref: vc_copylineY416toRGB :1948 / toRGBA :1978 / toRG48 :2485 /
    toR10k :1917 / toR12L :1828.
    """
    cfs = dfl_coeffs(16)
    y, u, v, _ = _y416_components(src)
    u = u - (1 << 15)
    v = v - (1 << 15)
    ysc = cfs.y_scale * (y - (1 << 12))
    sh = COMP_BASE + (16 - odepth)
    r = clamp_full(shr(ycbcr_to_r(cfs, ysc, u, v), sh), odepth)
    g = clamp_full(shr(ycbcr_to_g(cfs, ysc, u, v), sh), odepth)
    b = clamp_full(shr(ycbcr_to_b(cfs, ysc, u, v), sh), odepth)
    return r, g, b


@register(C.Y416, C.RGB)
def y416_to_rgb(src, width):
    r, g, b = y416_to_rgb_comps(src, 8)
    return pack_bytes(r, g, b)


@register(C.Y416, C.RGBA)
def y416_to_rgba(src, width):
    r, g, b = y416_to_rgb_comps(src, 8)
    return pack_bytes(r, g, b, torch.full_like(r, 0xFF))


@register(C.Y416, C.RG48)
def y416_to_rg48(src, width):
    r, g, b = y416_to_rgb_comps(src, 16)
    out = []
    for v in (r, g, b):
        lo, hi = split16(v)
        out += [lo, hi]
    return pack_bytes(*out)


@register(C.Y416, C.R10k)
def y416_to_r10k(src, width):
    """ref: vc_copylineY416toR10k, pixfmt_conv.c:1917."""
    r, g, b = y416_to_rgb_comps(src, 10)
    return pack_bytes(
        shr(r, 2),
        ((r & 0x3) << 6) | shr(g, 4),
        ((g & 0xF) << 4) | shr(b, 6),
        (b & 0x3F) << 2,
    )


@register(C.Y416, C.R12L)
def y416_to_r12l(src, width):
    """ref: vc_copylineY416toR12L, pixfmt_conv.c:1828 (LSB-first 12-bit pack)."""
    from ultragrid_tpu_torch.ops.convs_rgb import pack_r12l

    r, g, b = y416_to_rgb_comps(src, 12)
    return pack_r12l(r, g, b)


# ---------------------------------------------------------------------------
# VUYA
# ---------------------------------------------------------------------------


@register(C.VUYA, C.Y416)
def vuya_to_y416(src, width):
    """ref: vc_copylineVUYAtoY416, pixfmt_conv.c:2667 (8->16 via << 8)."""
    g = groups(src, 4)
    z = torch.zeros_like(g[..., 0])
    return pack_bytes(z, g[..., 1], z, g[..., 2], z, g[..., 0], z, g[..., 3])


@register(C.VUYA, C.UYVY)
def vuya_to_uyvy(src, width):
    """ref: vc_copylineVUYAtoUYVY, pixfmt_conv.c:2688."""
    g = groups(src, 8)
    u = shr(g[..., 1] + g[..., 5], 1)
    v = shr(g[..., 0] + g[..., 4], 1)
    return pack_bytes(u, g[..., 2], v, g[..., 7])


@register(C.VUYA, C.RGB)
def vuya_to_rgb(src, width):
    """ref: vc_copylineVUYAtoRGB, pixfmt_conv.c:2705 (CLAMP_FULL 8)."""
    cfs = dfl_coeffs(8)
    g = groups(src, 4)
    v = g[..., 0] - 128
    u = g[..., 1] - 128
    ysc = cfs.y_scale * (g[..., 2] - 16)
    r = clamp_full(shr(ycbcr_to_r(cfs, ysc, u, v), COMP_BASE), 8)
    gg = clamp_full(shr(ycbcr_to_g(cfs, ysc, u, v), COMP_BASE), 8)
    b = clamp_full(shr(ycbcr_to_b(cfs, ysc, u, v), COMP_BASE), 8)
    return pack_bytes(r, gg, b)


# ---------------------------------------------------------------------------
# DVS10 (legacy Centaurus 10-bit)
# ---------------------------------------------------------------------------


@register(C.DVS10, C.UYVY)
def dvs10_to_uyvy(src, width):
    """ref: vc_copylineDVS10, pixfmt_conv.c:690 (keep bytes 0-2,4-6 per 8)."""
    g = groups(src, 8)
    return pack_bytes(g[..., 0], g[..., 1], g[..., 2], g[..., 4], g[..., 5], g[..., 6])


@register(C.DVS10, C.v210)
def dvs10_to_v210(src, width):
    """ref: vc_copylineDVS10toV210, pixfmt_conv.c:595."""
    w = words_u32(src)
    # words are int64, so the shifts left do not wrap at 32 bits as the
    # reference's uint32 do; every mask lies below bit 32, which drops the
    # same bits
    b = ((w >> 24) * 0x00010101) & 0x00300C03
    a = w << 2
    b = b | (a & (0xFF << 2))
    a = a << 2
    b = b | (a & (0xFF00 << 4))
    a = a << 2
    b = b | (a & (0xFF0000 << 6))
    return u32_to_bytes(b)
