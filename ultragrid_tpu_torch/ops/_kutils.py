"""Shared helpers for the pixel-format conversions on tensors.

Port of ``ultragrid_tpu/ops/_kutils.py``.  Conversions take whole frames
shaped ``[H, linesize]`` uint8; their integer math is int32 with arithmetic
shifts (``>>`` on int32 tensors), matching the reference's ``comp_type_t``
semantics (ref: src/color_space.h:70-72).  Unsigned 32-bit words are held in
int64, so a right shift of a word never drags in a sign bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ultragrid_tpu_torch.ops.color import ColorCoeffs, Colorspace, get_color_coeffs


def groups(src: torch.Tensor, gbytes: int) -> torch.Tensor:
    """[H, L] uint8 -> [H, G, gbytes] int32 (whole groups only)."""
    h, l = src.shape
    g = l // gbytes
    return src[:, : g * gbytes].reshape(h, g, gbytes).to(torch.int32)


def pack_bytes(*byte_vals: torch.Tensor) -> torch.Tensor:
    """Stack per-group byte lanes [H, G] into [H, G*nbytes] uint8 (each lane
    keeps its low byte, as a cast to uint8 does)."""
    stacked = torch.stack(byte_vals, dim=-1).to(torch.uint8)
    return stacked.reshape(stacked.shape[0], -1)


def le16(src_groups: torch.Tensor) -> torch.Tensor:
    """Little-endian 16-bit values from int32 byte pairs [..., 2]."""
    return src_groups[..., 0] | (src_groups[..., 1] << 8)


def split16(v: torch.Tensor):
    """16-bit value -> (lo byte, hi byte)."""
    return v & 0xFF, (v >> 8) & 0xFF


def words_u32(src: torch.Tensor) -> torch.Tensor:
    """[H, L] uint8 -> [H, L//4] little-endian 32-bit words (int64, 0..2^32-1)."""
    h, l = src.shape
    w = src[:, : (l // 4) * 4].reshape(h, l // 4, 4).to(torch.int64)
    return w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)


def u32_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """[H, W] 32-bit words (any integer type) -> [H, W*4] uint8 little-endian."""
    w = w.to(torch.int64)
    b = torch.stack([w & 0xFF, (w >> 8) & 0xFF, (w >> 16) & 0xFF, (w >> 24) & 0xFF], dim=-1)
    return b.to(torch.uint8).reshape(w.shape[0], -1)


def f32(x: float) -> float:
    """x rounded to float32 (a constant as XLA folds it)."""
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """a * b + c with one rounding, as XLA's CPU backend fuses a product
    into the add that consumes it (``torch.addcmul``: one rounding on the
    CPU and on the card); scalars become float32 tensors."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))

    def t(x):
        return x if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float32, device=ref.device)

    a, b, c = t(a), t(b), t(c)
    return torch.addcmul(c.expand(torch.broadcast_shapes(a.shape, b.shape, c.shape)), a, b)


def cdiv2(x: torch.Tensor) -> torch.Tensor:
    """C-style ``x / 2``: truncation toward zero (not floor) for negatives."""
    return torch.div(x, 2, rounding_mode="trunc")


def clamp(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return torch.clamp(v, lo, hi)


def clamp_full(v: torch.Tensor, depth: int) -> torch.Tensor:
    """CLAMP_FULL (ref: src/color_space.h:96-98): SDI full-range limits."""
    return torch.clamp(v, 1 << (depth - 8), (255 << (depth - 8)) - 1)


def shr(v: torch.Tensor, n: int) -> torch.Tensor:
    """Arithmetic shift right (int32)."""
    return v >> n


def rgb_to_y(c: ColorCoeffs, r, g, b):
    return r * c.y_r + g * c.y_g + b * c.y_b


def rgb_to_cb(c: ColorCoeffs, r, g, b):
    return r * c.cb_r + g * c.cb_g + b * c.cb_b


def rgb_to_cr(c: ColorCoeffs, r, g, b):
    return r * c.cr_r + g * c.cr_g + b * c.cr_b


def ycbcr_to_r(c: ColorCoeffs, y_scaled, cb, cr):
    return y_scaled + cr * c.r_cr


def ycbcr_to_g(c: ColorCoeffs, y_scaled, cb, cr):
    return y_scaled + cb * c.g_cb + cr * c.g_cr


def ycbcr_to_b(c: ColorCoeffs, y_scaled, cb, cr):
    return y_scaled + cb * c.b_cb


def dfl_coeffs(depth: int) -> ColorCoeffs:
    return get_color_coeffs(Colorspace.DFL, depth)
