"""DXT1 / DXT5-YCoCg texture compression on tensors.

Port of ``ultragrid_tpu/ops/dxt.py`` (itself a re-derivation of the
reference CUDA kernels, ref: cuda_dxt/cuda_dxt.cu — dxt_encode<1> :514-621,
dxt_encode<6> :472-511, helpers :137-410, yuv_to_rgb :444-452).  Blocks are
an array axis: every step is a float32 op over ``[nblocks, 16]`` lanes, as
in the reference, and the bit packing is integer.  The JAX package runs this
as XLA code outside any Pallas kernel; here it is plain PyTorch on the
frame's device.

Bit-equality with the reference as XLA compiles it for the CPU.  XLA
rewrites ``x / c`` as ``x * (1 / c)`` for a constant ``c`` (:data:`_R255`
and friends), its CPU backend fuses a product into the add or subtract that
consumes it (one rounding) wherever the product has no other use, and it
sums a block's 16 lanes in a fixed order, fused.
The port writes each such fused multiply-add out as ``_kutils.fma``
(``torch.addcmul``: one rounding on the CPU and on the card) and each lane
sum as :func:`_lane_dot`, so the CPU and the card compute one thing, the
reference's.  Where XLA computes one value two ways in two fusions (the
RGB -> Cg term), the port does too.  32-bit words are held in int64 (no
sign bit to drag in on a right shift; ``~`` is masked back to 32 bits).

Outputs are flat uint8 in raster block order, 8 B/block (DXT1) or 16
B/block (DXT5), wire-compatible with the reference's DXT frames.
"""

from __future__ import annotations

import torch

from ultragrid_tpu_torch.ops._kutils import f32, fma

_OFFSET = 128.0 / 255.0
_U32 = 0xFFFFFFFF

_R255 = f32(1.0 / 255.0)
_R31, _R63 = f32(1.0 / 31.0), f32(1.0 / 63.0)
_R3, _R7, _R14 = f32(1.0 / 3.0), f32(1.0 / 7.0), f32(1.0 / 14.0)
_TWO_THIRDS = f32(2.0 / 3.0)


def _lane_dot(x: torch.Tensor, y: torch.Tensor, vector: bool) -> torch.Tensor:
    """Sum over the 16 lanes of each block of x * y in XLA's CPU order, each
    product fused into its add: lane by lane, or (``vector``, where XLA
    vectorises the reduction) lanes i and i + 8, then halves 4, 2, 1."""
    if not vector:
        s = x[:, 0] * y[:, 0]
        for i in range(1, x.shape[1]):
            s = fma(x[:, i], y[:, i], s)
        return s
    s = fma(x[:, :8], y[:, :8], x[:, 8:] * y[:, 8:])
    s = s[:, :4] + s[:, 4:]
    s = s[:, :2] + s[:, 2:]
    return s[:, 0] + s[:, 1]


class _Chan:
    """One colour channel of the blocks, [N, 16]: unit-range floats, and,
    for byte input, the bytes (``v = b8 * _R255``), so that ``v + c`` can
    be the reference's fused ``b8 * _R255 + c``."""

    def __init__(self, v: torch.Tensor, b8: torch.Tensor = None):
        self.v, self.b8 = v, b8

    def plus(self, c) -> torch.Tensor:
        return self.v + c if self.b8 is None else fma(self.b8, _R255, c)


def _blockify(px: torch.Tensor):
    """[H, W, C] pixels -> per channel [nblocks, 16] (raster block order,
    raster lanes in a block)."""
    h, width, c = px.shape
    nby, nbx = h // 4, width // 4
    blocks = px[: nby * 4, : nbx * 4].reshape(nby, 4, nbx, 4, c)
    blocks = blocks.permute(0, 2, 1, 3, 4).reshape(nby * nbx, 16, c)
    return [blocks[..., i] for i in range(c)]


def _rgb_chans(rgb_bytes: torch.Tensor, width: int):
    """RGB [H, >=3W] uint8 -> three byte-backed channels."""
    h = rgb_bytes.shape[0]
    px = rgb_bytes[:, : 3 * width].reshape(h, width, 3).to(torch.float32)
    return [_Chan(b8 * _R255, b8) for b8 in _blockify(px)]


def _saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def _u32(x):
    """float -> integer, truncated as the C cast (the values are >= 0)."""
    return x.to(torch.int64)


def _words_to_bytes(*words):
    """32-bit words [N] (int64) -> interleaved LE bytes [N * 4 * len(words)]."""
    w = torch.stack(words, dim=-1)  # [N, nwords]
    b = torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(-1)


def _pack_2bit(idx: torch.Tensor) -> torch.Tensor:
    """[N, 16] values 0..3 -> [N] word with lane i at bits 2i (disjoint
    fields, so the OR is the reference's uint32 sum)."""
    shifts = torch.arange(16, dtype=torch.int64, device=idx.device) * 2
    return (idx << shifts[None, :]).sum(dim=1)


def _dxt1_core(r: _Chan, g: _Chan, b: _Chan):
    """Three channels [N, 16] -> (palette_code, indices) words [N].

    ref: dxt_encode<1>, cuda_dxt.cu:514-621.
    """
    minr, ming, minb = r.v.amin(dim=1), g.v.amin(dim=1), b.v.amin(dim=1)
    maxr, maxg, maxb = r.v.amax(dim=1), g.v.amax(dim=1), b.v.amax(dim=1)

    # inset bounding box by 1/16
    def inset(lo, hi):
        ins = (hi - lo) * 0.0625
        return lo + ins, hi - ins

    minr, maxr = inset(minr, maxr)
    ming, maxg = inset(ming, maxg)
    minb, maxb = inset(minb, maxb)

    # diagonal selection via covariance with box center
    cr = (minr + maxr) * 0.5
    cg = (ming + maxg) * 0.5
    cb = (minb + maxb) * 0.5
    dr, dg, db = r.plus(-cr[:, None]), g.plus(-cg[:, None]), b.plus(-cb[:, None])
    cov_x = _lane_dot(dr, db, vector=False)
    cov_y = _lane_dot(dg, db, vector=False)
    minr, maxr = torch.where(cov_x < 0, maxr, minr), torch.where(cov_x < 0, minr, maxr)
    ming, maxg = torch.where(cov_y < 0, maxg, ming), torch.where(cov_y < 0, ming, maxg)

    # endpoint quantization to 565 (ref: encode_endpoint :424-440)
    def endpoint(cr_, cg_, cb_):
        q = (torch.round(_saturate(cr_) * 31.0), torch.round(_saturate(cg_) * 63.0),
             torch.round(_saturate(cb_) * 31.0))
        code = (_u32(q[0]) << 11) + (_u32(q[1]) << 5) + _u32(q[2])
        return code, q

    max_code, qmax = endpoint(maxr, maxg, maxb)
    min_code, qmin = endpoint(minr, ming, minb)
    units = (_R31, _R63, _R31)
    maxr, maxg, maxb = (q * u for q, u in zip(qmax, units))

    swap = max_code < min_code
    palette_code = torch.where(swap, min_code + (max_code << 16), max_code + (min_code << 16))

    # project colors onto the min-max line, quantize t to palette index;
    # the min end's scaling is fused into the direction
    dir_r, dir_g, dir_b = (fma(lo, u, -hi) for lo, u, hi in zip(qmin, units, (maxr, maxg, maxb)))
    dir_sqr = fma(dir_b, dir_b, fma(dir_r, dir_r, dir_g * dir_g))
    inv = torch.where(dir_sqr > 0, 1.0 / torch.where(dir_sqr > 0, dir_sqr, 1.0), 0.0)
    t_r, t_g, t_b = dir_r * inv, dir_g * inv, dir_b * inv
    t_bias = fma(t_b, maxb, fma(t_r, maxr, t_g * maxg))
    col_t = fma(b.v, t_b[:, None], fma(r.v, t_r[:, None], g.v * t_g[:, None])) - t_bias[:, None]
    col_idx = _u32(fma(_saturate(col_t), 3.0, 0.5))  # trunc, as the C cast

    indices = _pack_2bit(col_idx)
    indices = torch.where(max_code != min_code, indices, 0)
    indices = torch.where(swap, ~indices & _U32, indices)
    # remap 00->00, 01->10, 10->11, 11->01
    lsbs = indices & 0x55555555
    msbs = indices & 0xAAAAAAAA
    indices = msbs ^ (2 * lsbs + (msbs >> 1))
    return palette_code, indices


def _uyvy_to_px444(src: torch.Tensor, width: int):
    """UYVY [H, 2W] -> per-pixel (y, u, v) unit-range floats, chroma
    duplicated (ref: yuv422_to_yuv444_kernel cuda_dxt.cu:697+), and the
    chroma bytes."""
    h = src.shape[0]
    b8 = src[:, : 2 * width].reshape(h, width // 2, 4).to(torch.float32)
    g = b8 * _R255
    y = torch.stack([g[..., 1], g[..., 3]], dim=-1).reshape(h, width)
    u8, v8 = b8[..., 0].repeat_interleave(2, dim=1), b8[..., 2].repeat_interleave(2, dim=1)
    return y, u8 * _R255, v8 * _R255, u8, v8


def _uyvy_rgb_chans(src: torch.Tensor, width: int):
    """UYVY -> BT.709 RGB channels (ref: yuv_to_rgb, cuda_dxt.cu:444-452),
    as the reference's fusions round it: the chroma offsets fused into the
    byte scaling, each chroma product into its add."""
    y, _, _, u8, v8 = _uyvy_to_px444(src, width)
    yy = (y - 0.0625) * 1.1643
    uu, vv = fma(u8, _R255, -0.5), fma(v8, _R255, -0.5)
    r = fma(vv, 1.7926, yy)
    g = yy - 0.2132 * uu - 0.5328 * vv
    b = fma(uu, 2.1124, yy)
    return [_Chan(c) for c in _blockify(torch.stack([r, g, b], dim=-1))]


def dxt1_encode_rgb(rgb: torch.Tensor, width: int) -> torch.Tensor:
    """RGB [H, >=3W] uint8 -> DXT1 bytes (8 B per 4x4 block)."""
    return _words_to_bytes(*_dxt1_core(*_rgb_chans(rgb, width)))


def dxt1_encode_uyvy(src: torch.Tensor, width: int) -> torch.Tensor:
    """UYVY -> (BT.709 YUV->RGB) -> DXT1 (ref: cuda_dxt yuv pre-pass path)."""
    return _words_to_bytes(*_dxt1_core(*_uyvy_rgb_chans(src, width)))


def dxt1_yuv_encode_uyvy(src: torch.Tensor, width: int) -> torch.Tensor:
    """DXT1_YUV: YCbCr packed straight into DXT1 channels (ref: RTDXT
    dxt_glsl.cpp DXT1_YUV mode — no color conversion)."""
    y, u, v, u8, v8 = _uyvy_to_px444(src, width)
    yb, ub, vb, u8b, v8b = _blockify(torch.stack([y, u, v, u8, v8], dim=-1))
    return _words_to_bytes(*_dxt1_core(_Chan(yb), _Chan(ub, u8b), _Chan(vb, v8b)))


def _dxt5_ycocg_core(r: _Chan, g: _Chan, b: _Chan):
    """Three channels [N, 16] -> 4 32-bit words per block (DXT5-YCoCg).

    ref: dxt_encode<6>, cuda_dxt.cu:472-511 + helpers :243-410, with the
    RGB -> YCoCg conversion (ConvertRGBToYCoCg, :141-148) rounded as the
    reference's fusions round it.
    """
    two_g = g.v + g.v
    y = b.plus(r.plus(two_g)) * 0.25
    co = ((r.v + r.v) - (b.v + b.v)) * 0.25 + _OFFSET
    # Cg as the covariance and the palette see it
    cg = ((two_g - r.v) - b.v) * 0.25 + _OFFSET
    # as the bounding box sees it: the byte scaling of b fused
    cg_box = (two_g - r.v) - b.v if b.b8 is None else fma(b.b8, -_R255, two_g - r.v)
    cg_box = cg_box * 0.25 + _OFFSET

    miny, minco, mincg = y.amin(dim=1), co.amin(dim=1), cg_box.amin(dim=1)
    maxy, maxco, maxcg = y.amax(dim=1), co.amax(dim=1), cg_box.amax(dim=1)

    # SelectYCoCgDiagonal: swap Cg endpoints if covariance negative
    midco = (maxco + minco) * 0.5
    midcg = (maxcg + mincg) * 0.5
    cov = _lane_dot(co - midco[:, None], cg - midcg[:, None], vector=True)
    swap = cov < 0
    mincg, maxcg = torch.where(swap, maxcg, mincg), torch.where(swap, mincg, maxcg)

    # ScaleYCoCg
    m = torch.maximum(
        torch.maximum(torch.abs(minco - _OFFSET), torch.abs(mincg - _OFFSET)),
        torch.maximum(torch.abs(maxco - _OFFSET), torch.abs(maxcg - _OFFSET)),
    )
    scale = torch.where(m < 32.0 / 255.0, 4.0, torch.where(m < 64.0 / 255.0, 2.0, 1.0)).to(torch.float32)

    # EmitEndPointsYCoCgDXT5 (scale is 1, 2 or 4: the products are exact)
    def rescale(c):
        return (c - _OFFSET) * scale + _OFFSET

    eminco, emincg = rescale(minco), rescale(mincg)
    emaxco, emaxcg = rescale(maxco), rescale(maxcg)
    # InsetCoCgBBox
    ins_co = (emaxco - eminco) * 0.0625 - (8.0 / 255.0) / 16.0
    ins_cg = (emaxcg - emincg) * 0.0625 - (8.0 / 255.0) / 16.0
    eminco = _saturate(eminco + ins_co)
    emincg = _saturate(emincg + ins_cg)
    emaxco = _saturate(emaxco - ins_co)
    emaxcg = _saturate(emaxcg - ins_cg)

    qmaxco, qmaxcg = torch.round(emaxco * 31.0), torch.round(emaxcg * 63.0)
    qminco, qmincg = torch.round(eminco * 31.0), torch.round(emincg * 63.0)
    iscale = _u32(scale) - 1
    word_hi = (_u32(qmaxco) << 11) | (_u32(qmaxcg) << 5) | iscale
    word_lo = (_u32(qminco) << 11) | (_u32(qmincg) << 5) | iscale
    cocg_endpoints = word_hi | (word_lo << 16)

    # expand quantized endpoints back to floats, undo rescale
    def expand(q, bits):
        qi = _u32(q)
        e = ((qi << (8 - bits)) | (qi >> (2 * bits - 8))).to(torch.float32)
        return fma(e, _R255, -_OFFSET) / scale + _OFFSET

    c0co, c0cg = expand(qmaxco, 5), expand(qmaxcg, 6)
    c1co, c1cg = expand(qminco, 5), expand(qmincg, 6)

    # EmitIndicesYCoCgDXT5: 4-color palette over (Co, Cg)
    c2co = fma(c1co - c0co, _R3, c0co)
    c2cg = fma(c1cg - c0cg, _R3, c0cg)
    c3co = fma(c1co - c0co, _TWO_THIRDS, c0co)
    c3cg = fma(c1cg - c0cg, _TWO_THIRDS, c0cg)

    def dist(pc, pg):
        dc, dg = co - pc[:, None], cg - pg[:, None]
        return fma(dc, dc, dg * dg)

    d0, d1, d2, d3 = dist(c0co, c0cg), dist(c1co, c1cg), dist(c2co, c2cg), dist(c3co, c3cg)
    bx = d0 > d3
    by = d1 > d2
    bz = d0 > d2
    bw = d1 > d3
    b4 = d2 > d3
    index = (bx & b4).to(torch.int64) | (((by & bz) | (bx & bw)).to(torch.int64) << 1)
    cocg_indices = _pack_2bit(index)

    # InsetYBBox
    ins_y = (maxy - miny) * 0.03125 - (16.0 / 255.0) / 32.0
    iminy = _saturate(miny + ins_y)
    imaxy = _saturate(maxy - ins_y)

    # EmitAlphaEndPointsYCoCgDXT5: byte0 = max, byte1 = min
    c0 = _u32(torch.round(iminy * 255.0))
    c1 = _u32(torch.round(imaxy * 255.0))
    alpha_word0 = (c0 << 8) | c1

    # EmitAlphaIndicesYCoCgDXT5 (ref: cuda_dxt.cu:360-410): thresholds
    # (k * max + (7 - k) * min) / 7 + mid, the product by a weight other
    # than 1 and 2 fused into the sum, the sum into the / 7
    mid = (imaxy - iminy) * _R14
    ab = [iminy + mid]
    for k in (6, 5, 4, 3, 2, 1):
        wmax, wmin = float(k), float(7 - k)
        if k == 1:
            s = fma(iminy, wmin, imaxy)
        elif k == 2:
            s = fma(iminy, wmin, imaxy + imaxy)
        elif k == 5:
            s = fma(imaxy, wmax, iminy + iminy)
        elif k == 6:
            s = fma(imaxy, wmax, iminy)
        else:
            s = fma(imaxy, wmax, iminy * wmin)
        ab.append(fma(s, _R7, mid))
    index = torch.ones_like(y, dtype=torch.int64)
    for t in ab:
        index = index + (y <= t[:, None]).to(torch.int64)
    index = index & 7
    index = index ^ (index < 2).to(torch.int64)

    # pack 16 3-bit indices into 48 bits starting at bit 16 of word0; the
    # reference's uint32 shift drops what passes bit 31, hence the mask
    idx64_lo = torch.zeros_like(cocg_indices)
    for i in range(6):
        idx64_lo = idx64_lo | ((index[:, i] << (3 * i + 16)) & _U32)
    # i == 5 spills one bit into the high word (3*5+16 = 31)
    idx64_hi = index[:, 5] >> 1
    for i in range(6, 16):
        idx64_hi = idx64_hi | (index[:, i] << (3 * i - 16))

    word0 = alpha_word0 | idx64_lo
    return word0, idx64_hi, cocg_endpoints, cocg_indices


def dxt5_ycocg_encode_rgb(rgb: torch.Tensor, width: int) -> torch.Tensor:
    """RGB [H, >=3W] uint8 -> DXT5-YCoCg bytes (16 B per 4x4 block)."""
    return _words_to_bytes(*_dxt5_ycocg_core(*_rgb_chans(rgb, width)))


def dxt5_ycocg_encode_uyvy(src: torch.Tensor, width: int) -> torch.Tensor:
    """UYVY -> (BT.709 YUV->RGB) -> DXT5-YCoCg."""
    return _words_to_bytes(*_dxt5_ycocg_core(*_uyvy_rgb_chans(src, width)))


# ---------------------------------------------------------------------------
# decoders (receiver path; ref: dxt_compress display shaders)
# ---------------------------------------------------------------------------


def _bytes_to_words(buf: torch.Tensor, nwords: int):
    b = buf.reshape(-1, nwords, 4).to(torch.int64)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _expand565(code):
    r5 = (code >> 11) & 0x1F
    g6 = (code >> 5) & 0x3F
    b5 = code & 0x1F
    r = ((r5 << 3) | (r5 >> 2)).to(torch.float32)
    g = ((g6 << 2) | (g6 >> 4)).to(torch.float32)
    b = ((b5 << 3) | (b5 >> 2)).to(torch.float32)
    return r, g, b


def _unblockify(px_blocks: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[N, 16, C] -> [H, W*C] uint8."""
    nby, nbx = height // 4, width // 4
    c = px_blocks.shape[-1]
    arr = px_blocks.reshape(nby, nbx, 4, 4, c).permute(0, 2, 1, 3, 4)
    return arr.reshape(height, width * c)


def _sel_2bit(words: torch.Tensor) -> torch.Tensor:
    """[N] words -> [N, 16] 2-bit fields, lane i from bits 2i."""
    shifts = torch.arange(16, dtype=torch.int64, device=words.device) * 2
    return (words[:, None] >> shifts[None, :]) & 3


def dxt1_decode_rgb(buf: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """DXT1 bytes -> RGB [H, 3W] uint8 (4-color opaque mode)."""
    w = _bytes_to_words(buf, 2)
    pal, idx = w[:, 0], w[:, 1]
    r0, g0, b0 = _expand565(pal & 0xFFFF)
    r1, g1, b1 = _expand565(pal >> 16)

    # 4-color palette (the encoder always emits c0 >= c1); the sums are
    # exact integers
    def palette(a0, a1):
        return torch.stack([a0, a1, (2 * a0 + a1) * _R3, (a0 + 2 * a1) * _R3], dim=-1)

    sel = _sel_2bit(idx)
    px = torch.stack([torch.gather(palette(a0, a1), 1, sel)
                      for a0, a1 in ((r0, r1), (g0, g1), (b0, b1))], dim=-1)
    return _unblockify(torch.round(px).to(torch.uint8), height, width)


def dxt5_ycocg_decode_rgb(buf: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """DXT5-YCoCg bytes -> RGB [H, 3W] uint8
    (ref: display_dxt5ycocg_fp.glsl semantics)."""
    w = _bytes_to_words(buf, 4)
    w0, w1, cocg_pal, cocg_idx = w[:, 0], w[:, 1], w[:, 2], w[:, 3]

    # alpha (Y) palette: a0 = byte0 (max), a1 = byte1 (min); 8-level mode
    # (the weighted sums are exact integers)
    a0 = (w0 & 0xFF).to(torch.float32)
    a1 = ((w0 >> 8) & 0xFF).to(torch.float32)
    levels = [a0, a1] + [((7 - k) * a0 + k * a1) * _R7 for k in range(1, 7)]
    apal = torch.stack(levels, dim=-1)  # [N, 8]

    # 48-bit alpha indices live at bit 16 of w0 through w1 (static shifts)
    sels = []
    for i in range(16):
        p = 3 * i + 16
        if p + 3 <= 32:
            sels.append((w0 >> p) & 7)
        elif p == 31:  # index 5 spans the word boundary
            sels.append(((w0 >> 31) & 1) | ((w1 & 3) << 1))
        else:
            sels.append((w1 >> (p - 32)) & 7)
    asel = torch.stack(sels, dim=-1)  # [N, 16]
    yv = torch.gather(apal, 1, asel) * _R255

    # CoCg palette
    chi = cocg_pal & 0xFFFF
    clo = cocg_pal >> 16
    scale = ((chi & 3) + 1).to(torch.float32)
    co0, cg0, _ = _expand565(chi)
    co1, cg1, _ = _expand565(clo)

    def palette(a0_, a1_):
        return torch.stack([a0_, a1_, fma(a1_ - a0_, _R3, a0_), fma(a1_ - a0_, _TWO_THIRDS, a0_)], dim=-1)

    sel = _sel_2bit(cocg_idx)
    co = fma(torch.gather(palette(co0, co1), 1, sel), _R255, -_OFFSET) / scale[:, None]
    cg = fma(torch.gather(palette(cg0, cg1), 1, sel), _R255, -_OFFSET) / scale[:, None]

    r = yv + co - cg
    g = yv + cg
    b = yv - co - cg
    px = torch.stack([r, g, b], dim=-1)
    px = torch.round(torch.clamp(px, 0.0, 1.0) * 255.0).to(torch.uint8)
    return _unblockify(px, height, width)
