"""Postprocess / filter operations on tensors: scale, deinterlace, crop,
mirror, gamma, colour matrices, blank, logo, noise.

Port of ``ultragrid_tpu/ops/postprocess.py`` (ref: src/vo_postprocess/
scale.c, deinterlace.c, crop, border, interlace; the pixel-touching parts of
src/capture_filter/: gamma, grayscale, mirror, flip, matrix, blank, logo).
Every function takes a packed uint8 frame ``[H, linesize]`` tensor and
returns one on the same device; none writes into its input.  The JAX package
runs these as XLA code outside any Pallas kernel; here they are plain
PyTorch on the frame's device.

Float32 as the reference computes it on the CPU.  The jitted reference
functions are fused by XLA: in ``grayscale`` the first and third products
are fused into the adds that consume them (``_kutils.fma``,
``torch.addcmul``: one rounding on the CPU and on the card).  The
reference's ``color_matrix``, ``logo_blit``, ``matrix2_uyvy`` and
``scale_bilinear_rgb`` run eagerly, one XLA computation per operation, so
each product and sum rounds on its own and a division stays a division (the
logo's is taken on the host: the card turns a division by a host scalar
into a product).  ``color_matrix``'s K = 3 product follows XLA's CPU dot:
output channels 0 and 1 sum their three products left to right, channel 2
as a chain of fused multiply-adds.  ``matrix2_uyvy``'s coefficients are
float32: the JAX package runs with 64-bit floats off, so its ``float64``
arrays compute in float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.ops._kutils import f32, fma, u32_to_bytes, words_u32
from ultragrid_tpu_torch.types import Codec, get_bits_per_component, get_codec_info


def _ncomp(codec: Codec) -> int:
    return 3 if codec == Codec.RGB else 4


def _pixels(src: torch.Tensor, width: int, codec: Codec) -> torch.Tensor:
    """[H, linesize] RGB(A) bytes -> float32 [H, W, ncomp]."""
    n = _ncomp(codec)
    return src[:, : n * width].reshape(src.shape[0], width, n).to(torch.float32)


# ---------------------------------------------------------------------------
# scale (ref: vo_postprocess/scale.c — GL nearest sampling over texels)
# ---------------------------------------------------------------------------


def scale_nearest(src: torch.Tensor, width: int, codec: Codec, new_width: int, new_height: int) -> torch.Tensor:
    """Nearest-neighbour scale at pixel-block granularity (UYVY scales in
    2-pixel texels, like the reference's RGBA-texture trick).

    The texel centre of output index i is ``(i + 0.5) * n_in / n_out`` in
    float32, evaluated in the reference's order and truncated, so the
    sampled indices are the reference's.
    """
    info = get_codec_info(codec)
    bpx, bby = info.block_size_pixels, info.block_size_bytes
    h = src.shape[0]
    blocks_in, blocks_out = width // bpx, new_width // bpx
    g = src[:, : blocks_in * bby].reshape(h, blocks_in, bby)

    def centres(n_out: int, n_in: int) -> torch.Tensor:
        i = torch.arange(n_out, dtype=torch.float32, device=src.device)
        return ((i + 0.5) * n_in / n_out).to(torch.int64)

    out = g[centres(new_height, h)][:, centres(blocks_out, blocks_in)]
    return out.reshape(new_height, blocks_out * bby)


# ---------------------------------------------------------------------------
# deinterlace (ref: vc_deinterlace_ex video_codec.c; vo_postprocess/deinterlace.c)
# ---------------------------------------------------------------------------


def _avg_lines(a: torch.Tensor, b: torch.Tensor, codec: Codec) -> torch.Tensor:
    """(x + y + 1) >> 1 at component granularity (ref: vc_deinterlace_ex)."""
    if codec == Codec.v210:
        # 32-bit words as int64; exact replica of the reference
        # (video_codec.c v210 branch): the top field is averaged UNMASKED,
        # so padding bits fold into bits 30-31
        wa, wb = words_u32(a), words_u32(b)
        f0 = ((wa & 0x3FF) + (wb & 0x3FF) + 1) >> 1
        f1 = ((((wa >> 10) & 0x3FF) + ((wb >> 10) & 0x3FF) + 1) >> 1) << 10
        f2 = (((wa >> 20) + (wb >> 20) + 1) >> 1) << 20
        return u32_to_bytes(f2 | f1 | f0)
    if get_bits_per_component(codec) > 8:
        a16 = a.to(torch.int32).reshape(a.shape[0], -1, 2)
        b16 = b.to(torch.int32).reshape(b.shape[0], -1, 2)
        v = ((a16[..., 0] | (a16[..., 1] << 8)) + (b16[..., 0] | (b16[..., 1] << 8)) + 1) >> 1
        return torch.stack([v & 0xFF, (v >> 8) & 0xFF], dim=-1).to(torch.uint8).reshape(a.shape)
    return ((a.to(torch.int32) + b.to(torch.int32) + 1) >> 1).to(torch.uint8)


def deinterlace_blend(src: torch.Tensor, codec: Codec) -> torch.Tensor:
    """Linear blend: each line averaged with the next (ref: vc_deinterlace_ex:
    lines 0..n-2 get (l[y]+l[y+1]+1)/2, last line kept)."""
    return _avg_lines(src, torch.cat([src[1:], src[-1:]], dim=0), codec)


def deinterlace_bob_even(src: torch.Tensor) -> torch.Tensor:
    """Bob: duplicate even field lines (one field per output frame)."""
    return torch.repeat_interleave(src[0::2], 2, dim=0)[: src.shape[0]]


def deinterlace_bob_odd(src: torch.Tensor) -> torch.Tensor:
    return torch.repeat_interleave(src[1::2], 2, dim=0)[: src.shape[0]]


def deinterlace_linear(src: torch.Tensor, codec: Codec) -> torch.Tensor:
    """Linear: keep even field, interpolate odd lines from neighbours."""
    even = src[0::2]
    interp = _avg_lines(even, torch.cat([even[1:], even[-1:]], dim=0), codec)
    return torch.stack([even, interp], dim=1).reshape(-1, src.shape[1])[: src.shape[0]]


def interlace(src: torch.Tensor) -> torch.Tensor:
    """Progressive -> interlaced merged: weave the two fields of one frame
    (ref: vo_postprocess/interlace.c — field order preserved)."""
    return torch.cat([src[0::2], src[1::2]], dim=0)[: src.shape[0]]


# ---------------------------------------------------------------------------
# crop / mirror / flip (ref: vo_postprocess/crop.c; capture_filter/mirror.c,
# flip.c)
# ---------------------------------------------------------------------------


def crop(src: torch.Tensor, width: int, codec: Codec, x: int, y: int, w: int, h: int) -> torch.Tensor:
    """Crop at pixel-block granularity (a view of ``src``)."""
    info = get_codec_info(codec)
    bpx, bby = info.block_size_pixels, info.block_size_bytes
    return src[y : y + h, x // bpx * bby : (x + w) // bpx * bby]


# byte order of a mirrored 2-pixel group: UYVY's and YUYV's two lumas swap
_MIRROR_GROUP = {Codec.UYVY: [0, 3, 2, 1], Codec.YUYV: [2, 1, 0, 3]}


def mirror(src: torch.Tensor, width: int, codec: Codec) -> torch.Tensor:
    """Horizontal mirror (ref: capture_filter/mirror.c).

    Reverses pixel blocks; within UYVY blocks, swaps the two lumas.
    """
    info = get_codec_info(codec)
    bpx, bby = info.block_size_pixels, info.block_size_bytes
    h, nb = src.shape[0], width // bpx
    g = torch.flip(src[:, : nb * bby].reshape(h, nb, bby), dims=[1])
    if codec in _MIRROR_GROUP:
        g = g[..., _MIRROR_GROUP[codec]]
    return g.reshape(h, nb * bby)


def flip(src: torch.Tensor) -> torch.Tensor:
    """Vertical flip (ref: capture_filter/flip.c)."""
    return torch.flip(src, dims=[0])


# ---------------------------------------------------------------------------
# gamma / grayscale / color matrix (ref: capture_filter/gamma.cpp,
# grayscale, matrix.cpp)
# ---------------------------------------------------------------------------


def gamma_lut(gamma: float) -> np.ndarray:
    """The 256-entry table of ``gamma_correct``: round((v / 255) ** gamma *
    255) in float32 for every byte v, as XLA computes it per byte (the
    division as a product with float32(1 / 255))."""
    x = np.arange(256, dtype=np.float32) * np.float32(1.0 / 255.0)
    return np.round(np.power(x, np.float32(gamma)) * np.float32(255.0)).astype(np.uint8)


def gamma_correct(src: torch.Tensor, gamma: float) -> torch.Tensor:
    """Per-byte gamma on 8-bit components (RGB-family frames): one gather
    from a 256-entry table built on the host (a table gather is cheap on
    the card; the reference computes ``pow`` per byte)."""
    lut = torch.as_tensor(gamma_lut(gamma), device=src.device)
    return lut[src.to(torch.int64)]


_GRAY_U = {Codec.UYVY: (0, 2), Codec.YUYV: (1, 3)}


def grayscale(src: torch.Tensor, width: int, codec: Codec) -> torch.Tensor:
    """Neutralize chroma (UYVY) or desaturate via BT.709 luma (RGB)."""
    h = src.shape[0]
    if codec in _GRAY_U:
        g = src[:, : 2 * width].reshape(h, width // 2, 4).clone()
        g[..., list(_GRAY_U[codec])] = 128
        return g.reshape(h, 2 * width)
    if codec in (Codec.RGB, Codec.RGBA):
        px = _pixels(src, width, codec)
        r, g, b = px[..., 0], px[..., 1], px[..., 2]
        # XLA's fusion: fma(b, 0.0722, fma(r, 0.2126, 0.7152 * g))
        y = fma(b, f32(0.0722), fma(r, f32(0.2126), g * f32(0.7152)))
        out = px.to(torch.uint8)
        out[..., :3] = torch.round(y).to(torch.uint8)[..., None]
        return out.reshape(h, _ncomp(codec) * width)
    raise ValueError(f"grayscale: unsupported codec {codec}")


def color_matrix(src: torch.Tensor, width: int, codec: Codec, matrix: np.ndarray) -> torch.Tensor:
    """3x3 color matrix on RGB(A) pixels (ref: capture_filter/matrix.cpp)."""
    px = _pixels(src, width, codec)
    m = torch.as_tensor(np.asarray(matrix, np.float32), device=src.device)
    x0, x1, x2 = px[..., 0:1], px[..., 1:2], px[..., 2:3]
    # XLA's CPU dot: channels 0 and 1 summed left to right, channel 2 as an
    # ascending chain of fused multiply-adds
    first = (x0 * m[:2, 0] + x1 * m[:2, 1]) + x2 * m[:2, 2]
    last = fma(x2, m[2, 2], fma(x1, m[2, 1], x0 * m[2, 0]))
    rgb = torch.clamp(torch.round(torch.cat([first, last], dim=-1)), 0, 255).to(torch.uint8)
    if codec != Codec.RGB:
        rgb = torch.cat([rgb, px[..., 3:4].to(torch.uint8)], dim=-1)
    return rgb.reshape(src.shape[0], _ncomp(codec) * width)


def blank_region(src: torch.Tensor, width: int, codec: Codec, x: int, y: int, w: int, h: int,
                 color: int = 0) -> torch.Tensor:
    """Blank a rectangle (ref: capture_filter/blank.cpp)."""
    info = get_codec_info(codec)
    bpx, bby = info.block_size_pixels, info.block_size_bytes
    x0, x1 = x // bpx * bby, (x + w) // bpx * bby
    if codec in (Codec.UYVY, Codec.YUYV):
        group = [128, 16, 128, 16] if codec == Codec.UYVY else [16, 128, 16, 128]
        fill = np.tile(np.array(group, np.uint8), (x1 - x0) // 4)
    else:
        fill = np.full(x1 - x0, color, np.uint8)
    out = src.clone()
    out[y : y + h, x0:x1] = torch.as_tensor(fill, device=src.device)
    return out


def logo_blit(src: torch.Tensor, width: int, codec: Codec, logo_rgba: np.ndarray, x: int, y: int) -> torch.Tensor:
    """Alpha-blend an RGBA logo onto an RGB(A) frame (ref: capture_filter/logo.cpp)."""
    px = _pixels(src, width, codec)
    lh, lw = logo_rgba.shape[0], logo_rgba.shape[1]
    # the logo's own terms in float32 on the host: a true division (the
    # card would turn a division by a host scalar into a product)
    logo = np.asarray(logo_rgba, np.float32)
    alpha = logo[..., 3:4] / np.float32(255.0)
    keep, over = (torch.as_tensor(a, device=src.device) for a in (1 - alpha, logo[..., :3] * alpha))
    px[y : y + lh, x : x + lw, :3] = px[y : y + lh, x : x + lw, :3] * keep + over
    return torch.round(px).to(torch.uint8).reshape(src.shape[0], _ncomp(codec) * width)


def add_noise(src: torch.Tensor, generator: torch.Generator, amount: int = 16) -> torch.Tensor:
    """Additive uniform noise in [-amount, amount], clipped to 0..255 (ref:
    capture_filter/noise.cpp).  ``generator`` lives on ``src``'s device;
    the same seed gives the same noise there."""
    noise = torch.randint(-amount, amount + 1, src.shape, generator=generator, dtype=torch.int32,
                          device=src.device)
    return torch.clamp(src.to(torch.int32) + noise, 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# double framerate (temporal deinterlace) helper
# ---------------------------------------------------------------------------


def fields_to_frames(src: torch.Tensor, codec: Codec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split an interlaced-merged frame into two bob-doubled frames
    (ref: vo_postprocess double-framerate via putf timeout)."""
    return deinterlace_bob_even(src), deinterlace_bob_odd(src)


def matrix2_uyvy(src: torch.Tensor, width: int, matrix: np.ndarray) -> torch.Tensor:
    """3x3 matrix on unpacked YCbCr of a UYVY frame (ref:
    capture_filter/matrix2.c apply_to_uyvy): offsets Y-16 / C-128, the
    chroma rows use the two luma samples averaged, output truncated like the
    C double->uchar assignment (clamped to byte range).  Float32, as the
    reference computes it with 64-bit floats off."""
    m = [f32(v) for v in np.asarray(matrix, np.float64).reshape(9)]
    h = src.shape[0]
    g = src[:, : 2 * width].reshape(h, width // 2, 4).to(torch.float32)
    u, y1, v, y2 = g[..., 0] - 128.0, g[..., 1] - 16.0, g[..., 2] - 128.0, g[..., 3] - 16.0
    y = (y1 + y2) * 0.5
    ou = 128.0 + m[3] * y + m[4] * u + m[5] * v
    oy1 = 16.0 + m[0] * y1 + m[1] * u + m[2] * v
    ov = 128.0 + m[6] * y + m[7] * u + m[8] * v
    oy2 = 16.0 + m[0] * y2 + m[1] * u + m[2] * v
    out = torch.stack([ou, oy1, ov, oy2], dim=-1)
    return torch.clamp(torch.trunc(out), 0, 255).to(torch.uint8).reshape(h, 2 * width)


def scale_bilinear_rgb(src: torch.Tensor, width: int, codec: Codec, new_w: int, new_h: int) -> torch.Tensor:
    """Bilinear resample of an RGB(A) frame (ref: swmix interpolation,
    src/video_capture/swmix.c:208 — bilinear mode; bicubic is a GL shader)."""
    px = _pixels(src, width, codec)
    h, dev = src.shape[0], src.device
    # the scale factors are Python doubles that JAX rounds to float32
    ys = (torch.arange(new_h, dtype=torch.float32, device=dev) + 0.5) * f32(h / new_h) - 0.5
    xs = (torch.arange(new_w, dtype=torch.float32, device=dev) + 0.5) * f32(width / new_w) - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xs), 0, width - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=width - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[None, :, None]
    a, b = px[y0][:, x0], px[y0][:, x1]
    c, d = px[y1][:, x0], px[y1][:, x1]
    out = (a * (1 - wy) * (1 - wx) + b * (1 - wy) * wx
           + c * wy * (1 - wx) + d * wy * wx)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).reshape(new_h, _ncomp(codec) * new_w)
