"""Planar <-> packed conversions (I420/I422/I444/NV12/P010 and friends) on
tensors.

Port of ``ultragrid_tpu/ops/planar.py``: equivalents of the reference's planar converters
(ref: src/to_planar.c, src/from_planar.c, src/video_codec.c:950-1130).
Planar frames are flat uint8 arrays laid out exactly like the reference
(plane 0 = Y tightly packed width*height, then Cb, then Cr); packed frames are
``[H, linesize]`` uint8.

Only even widths are supported on the vectorized path (media sizes are even in
practice; the reference's odd-width edge handling is replicated where needed).
"""

from __future__ import annotations

import torch

from ultragrid_tpu_torch.ops._kutils import shr
from ultragrid_tpu_torch.types import Codec

C = Codec  # the reference's short name for the codec ids


def uyvy_to_i420(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """UYVY [H, 2W] -> I420 flat (Y, Cb, Cr); chroma = (a+b+1)/2 vertically
    (ref: uyvy_to_i420, to_planar.c:326-361)."""
    src = src[:, : 2 * width].to(torch.int32)
    h2 = height // 2
    u = src[:, 0::4]
    y0 = src[:, 1::4]
    v = src[:, 2::4]
    y1 = src[:, 3::4]
    y_plane = torch.stack([y0, y1], dim=-1).reshape(height, width)
    u_pairs = u.reshape(h2, 2, width // 2)
    v_pairs = v.reshape(h2, 2, width // 2)
    u_420 = shr(u_pairs[:, 0] + u_pairs[:, 1] + 1, 1)
    v_420 = shr(v_pairs[:, 0] + v_pairs[:, 1] + 1, 1)
    return torch.cat(
        [y_plane.reshape(-1), u_420.reshape(-1), v_420.reshape(-1)]
    ).to(torch.uint8)


def i420_8_to_uyvy(planes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """I420 flat -> UYVY [H, linesize] (ref: i420_8_to_uyvy, video_codec.c:1074)."""
    w2, h2 = width // 2, (height + 1) // 2
    y = planes[: width * height].reshape(height, width).to(torch.int32)
    off = width * height
    cb = planes[off : off + w2 * h2].reshape(h2, w2).to(torch.int32)
    cr = planes[off + w2 * h2 : off + 2 * w2 * h2].reshape(h2, w2).to(torch.int32)
    cb_full = cb.repeat_interleave(2, dim=0)[:height]
    cr_full = cr.repeat_interleave(2, dim=0)[:height]
    y0 = y[:, 0::2]
    y1 = y[:, 1::2]
    out = torch.stack([cb_full, y0, cr_full, y1], dim=-1).reshape(height, 2 * width)
    return out.to(torch.uint8)


def uyvy_to_i422(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """ref: uyvy_to_i422, video_codec.c:950-969."""
    src = src[:, : 2 * width]
    u = src[:, 0::4]
    y0 = src[:, 1::4]
    v = src[:, 2::4]
    y1 = src[:, 3::4]
    y_plane = torch.stack([y0, y1], dim=-1).reshape(height, width)
    return torch.cat([y_plane.reshape(-1), u.reshape(-1), v.reshape(-1)])


def i422_8_to_uyvy(planes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """ref: i422_8_to_uyvy, video_codec.c:1100-1116."""
    w2 = (width + 1) // 2
    y = planes[: width * height].reshape(height, width)
    off = width * height
    cb = planes[off : off + w2 * height].reshape(height, w2)
    cr = planes[off + w2 * height : off + 2 * w2 * height].reshape(height, w2)
    out = torch.stack([cb, y[:, 0::2], cr, y[:, 1::2]], dim=-1).reshape(height, 2 * width)
    return out


def i444_8_to_uyvy(planes: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """ref: i444_8_to_uyvy, video_codec.c:1118-1131 (chroma decimated, no avg)."""
    n = width * height
    y = planes[:n].reshape(height, width)
    cb = planes[n : 2 * n].reshape(height, width)
    cr = planes[2 * n : 3 * n].reshape(height, width)
    out = torch.stack([cb[:, 0::2], y[:, 0::2], cr[:, 0::2], y[:, 1::2]], dim=-1)
    return out.reshape(height, 2 * width)


def uyvy_to_nv12(src: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """ref: uyvy_to_nv12, to_planar.c:207-302 (chroma avg (a+b)/2)."""
    src = src[:, : 2 * width].to(torch.int32)
    h2 = height // 2
    y0 = src[:, 1::4]
    y1 = src[:, 3::4]
    y_plane = torch.stack([y0, y1], dim=-1).reshape(height, width)
    uv = torch.stack([src[:, 0::4], src[:, 2::4]], dim=-1).reshape(height, width)
    uv_pairs = uv.reshape(h2, 2, width)
    uv_420 = shr(uv_pairs[:, 0] + uv_pairs[:, 1], 1)
    return torch.cat([y_plane.reshape(-1), uv_420.reshape(-1)]).to(torch.uint8)


def _le16_flat(b: torch.Tensor) -> torch.Tensor:
    b = b.to(torch.int32)
    return b[0::2] | (b[1::2] << 8)


def _u16le_bytes(v: torch.Tensor) -> torch.Tensor:
    out = torch.stack([v & 0xFF, (v >> 8) & 0xFF], dim=-1).to(torch.uint8)
    return out.reshape(-1)


def y416_to_i444(src: torch.Tensor, width: int, height: int, depth: int) -> torch.Tensor:
    """Y416 [H, 8W] -> 16-bit planar I444 at `depth` (ref: video_codec.c:972-988)."""
    vals = _le16_flat(src.reshape(-1)).reshape(height, width, 4)
    sh = 16 - depth
    cb = shr(vals[..., 0], sh)
    y = shr(vals[..., 1], sh)
    cr = shr(vals[..., 2], sh)
    return torch.cat([_u16le_bytes(y.reshape(-1)), _u16le_bytes(cb.reshape(-1)), _u16le_bytes(cr.reshape(-1))])


def i444_16_to_y416(planes: torch.Tensor, width: int, height: int, in_depth: int) -> torch.Tensor:
    """ref: i444_16_to_y416, video_codec.c:991-1007."""
    n = width * height
    vals = _le16_flat(planes[: 6 * n])
    y = vals[:n].reshape(height, width)
    cb = vals[n : 2 * n].reshape(height, width)
    cr = vals[2 * n : 3 * n].reshape(height, width)
    sh = 16 - in_depth
    a = torch.full_like(y, 0xFFFF)
    out = torch.stack([cb << sh, y << sh, cr << sh, a], dim=-1)
    return _u16le_bytes(out.reshape(-1)).reshape(height, 8 * width)


def i422_16_to_y416(planes: torch.Tensor, width: int, height: int, in_depth: int) -> torch.Tensor:
    """ref: i422_16_to_y416, video_codec.c:1010-1030 (chroma duplicated)."""
    w2 = (width + 1) // 2
    vals = _le16_flat(planes)
    n = width * height
    y = vals[:n].reshape(height, width)
    cb = vals[n : n + w2 * height].reshape(height, w2)
    cr = vals[n + w2 * height : n + 2 * w2 * height].reshape(height, w2)
    sh = 16 - in_depth
    cb_full = cb.repeat_interleave(2, dim=1)[:, :width]
    cr_full = cr.repeat_interleave(2, dim=1)[:, :width]
    a = torch.full_like(y, 0xFFFF)
    out = torch.stack([cb_full << sh, y << sh, cr_full << sh, a], dim=-1)
    return _u16le_bytes(out.reshape(-1)).reshape(height, 8 * width)


def i420_16_to_y416(planes: torch.Tensor, width: int, height: int, in_depth: int) -> torch.Tensor:
    """ref: i420_16_to_y416, video_codec.c:1032-1072."""
    w2, h2 = (width + 1) // 2, (height + 1) // 2
    vals = _le16_flat(planes)
    n = width * height
    y = vals[:n].reshape(height, width)
    cb = vals[n : n + w2 * h2].reshape(h2, w2)
    cr = vals[n + w2 * h2 : n + 2 * w2 * h2].reshape(h2, w2)
    sh = 16 - in_depth
    cb_full = cb.repeat_interleave(2, dim=1)[:, :width].repeat_interleave(2, dim=0)[:height]
    cr_full = cr.repeat_interleave(2, dim=1)[:, :width].repeat_interleave(2, dim=0)[:height]
    a = torch.full_like(y, 0xFFFF)
    out = torch.stack([cb_full << sh, y << sh, cr_full << sh, a], dim=-1)
    return _u16le_bytes(out.reshape(-1)).reshape(height, 8 * width)


def v210_to_p010le(src: torch.Tensor, width: int, height: int):
    """v210 -> (Y plane u16 msb-aligned, interleaved CbCr plane), chroma rows
    averaged (a+b)/2 (ref: v210_to_p010le, to_planar.c:64-155)."""
    from ultragrid_tpu_torch.ops.convs_yuv import _v210_components

    (y0, y1, y2, y3, y4, y5), us, vs = _v210_components(src)
    h = src.shape[0]
    yv = torch.stack([y0, y1, y2, y3, y4, y5], dim=-1).reshape(h, -1)[:, :width] << 6
    uv = torch.stack(
        [us[0], vs[0], us[1], vs[1], us[2], vs[2]], axis=-1
    ).reshape(h, -1)[:, :width]
    uvp = uv.reshape(height // 2, 2, width)
    uv_avg = (shr(uvp[:, 0] + uvp[:, 1], 1)) << 6
    return yv.to(torch.uint16), uv_avg.to(torch.uint16)


def yuv422p10le_to_v210(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """10-bit planar 4:2:2 -> v210 (ref: yuv422p10le_to_v210, from_planar.c:295-333)."""
    from ultragrid_tpu_torch.ops.convs_yuv import _pack_v210_words

    h = height
    g = width // 6
    yb = y[:, : g * 6].reshape(h, g, 6).to(torch.int32)
    cbb = cb[:, : g * 3].reshape(h, g, 3).to(torch.int32)
    crb = cr[:, : g * 3].reshape(h, g, 3).to(torch.int32)
    return _pack_v210_words(
        [
            (cbb[..., 0], yb[..., 0], crb[..., 0]),
            (yb[..., 1], cbb[..., 1], yb[..., 2]),
            (crb[..., 1], yb[..., 3], cbb[..., 2]),
            (yb[..., 4], crb[..., 2], yb[..., 5]),
        ]
    )


# Note: I420 frames are flat (planar); they do not participate in the 2-D
# [H, linesize] conversion registry.  The pipeline/display layers call
# uyvy_to_i420 / i420_8_to_uyvy directly (mirroring the reference, which ships
# an i420 -> UYVY decompress shim rather than a line decoder).
