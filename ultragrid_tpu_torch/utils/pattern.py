"""Video test-pattern generator (ref: src/utils/video_pattern_generator.cpp).

Port of ``ultragrid_tpu/utils/pattern.py``.  Patterns are drawn on the host
into RGBA (8-bit) or RG48 (16-bit) words, as the reference draws them, then
copied to ``device`` once and converted to the requested codec there through
the port's conversion registry (the reference's fill into a default codec +
testcard_convert_buffer).  The bytes equal the JAX package's.

Supported: bars (default), ebu_bars, smpte_bars, blank[=color], gradient[=color],
gradient2[=maxval], gray, noise, uv_plane.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.types import Codec
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("pattern")

# ref: rect_colors[], src/video_capture/testcard_common.c:51-58 (ARGB words,
# little-endian byte order R,G,B,A in memory)
RECT_COLORS = [0xFF0000FF, 0xFF00FF00, 0xFFFF0000, 0xFF00FFFF, 0xFFFFFF00, 0xFFFF00FF]
COL_NUM = len(RECT_COLORS)


def _rgba_buffer(width: int, height: int) -> np.ndarray:
    return np.zeros((height, width), dtype=np.uint32)


def _fill_rect(buf: np.ndarray, x: int, y: int, w: int, h: int, color: int) -> None:
    h_img, w_img = buf.shape
    x2, y2 = min(x + w, w_img), min(y + h, h_img)
    x, y = max(x, 0), max(y, 0)
    buf[y:y2, x:x2] = color


def _bars(width: int, height: int) -> np.ndarray:
    """ref: image_pattern_bars::fill, video_pattern_generator.cpp:234-281."""
    buf = _rgba_buffer(width, height)
    rect_size = (width + COL_NUM - 1) // COL_NUM
    col_num = 0
    for j in range(0, height, rect_size):
        grey = 0xFF010101
        if j == rect_size * 2:
            _fill_rect(buf, 0, j, width, rect_size // 4, 0xFFFFFFFF)
            _fill_rect(buf, 0, j + rect_size * 3 // 4, width, rect_size - rect_size * 3 // 4, 0xFF000000)
        for i in range(0, width, rect_size):
            if j != rect_size * 2:
                _fill_rect(buf, i, j, rect_size, min(rect_size, height - j), RECT_COLORS[col_num])
                col_num = (col_num + 1) % COL_NUM
            else:
                _fill_rect(buf, i, j + rect_size // 4, rect_size, rect_size // 2, grey & 0xFFFFFFFF)
                grey = (grey + 0x00010101 * (255 // COL_NUM)) & 0xFFFFFFFF
    return buf


def _ebu_smpte_bars(width: int, height: int, f: int, columns: int) -> np.ndarray:
    """ref: image_pattern_ebu_smpte_bars, video_pattern_generator.cpp:289-323."""
    bars = [
        0xFF000000 | f << 16 | f << 8 | f,
        0xFF000000 | 0 << 16 | f << 8 | f,
        0xFF000000 | f << 16 | f << 8 | 0,
        0xFF000000 | 0 << 16 | f << 8 | 0,
        0xFF000000 | f << 16 | 0 << 8 | f,
        0xFF000000 | 0 << 16 | 0 << 8 | f,
        0xFF000000 | f << 16 | 0 << 8 | 0,
        0xFF000000,
    ]
    buf = _rgba_buffer(width, height)
    rect_size = (width + columns - 1) // columns
    col_num = 0
    for j in range(0, height, rect_size):
        for i in range(0, width, rect_size):
            _fill_rect(buf, i, j, rect_size, min(rect_size, height - j), bars[col_num])
            col_num = (col_num + 1) % columns
    return buf


def _smpte_bars(width: int, height: int) -> np.ndarray:
    """ref: image_pattern_smpte_bars, video_pattern_generator.cpp:325-372."""
    f, columns = 0xBF, 7
    buf = _ebu_smpte_bars(width, height, f, columns)
    bars = [
        0xFF000000 | f << 16 | f << 8 | f,
        0xFF000000 | 0 << 16 | f << 8 | f,
        0xFF000000 | f << 16 | f << 8 | 0,
        0xFF000000 | 0 << 16 | f << 8 | 0,
        0xFF000000 | f << 16 | 0 << 8 | f,
        0xFF000000 | 0 << 16 | 0 << 8 | f,
        0xFF000000 | f << 16 | 0 << 8 | 0,
    ]
    mid_strip_height = height // 3 - width // 6
    w = (width + columns - 1) // columns
    y = height // 3 * 2
    for i in range(columns):
        color = 0 if i % 2 == 1 else bars[columns - 1 - i]
        _fill_rect(buf, i * w, y, w, mid_strip_height, color)
    bottom = [0xFF000000 | 105 << 16 | 63 << 8, 0xFFFFFFFF, 0xFF000000 | 119 << 16, 0xFF000000, 0xFF000000, 0xFF000000]
    columns = 6
    w = (width + columns - 1) // columns
    y += mid_strip_height
    for i in range(columns):
        _fill_rect(buf, i * w, y, w, width // 6, bottom[i])
    return buf


def _gradient_rg48(width: int, height: int, color: int) -> np.ndarray:
    """ref: image_pattern_gradient, video_pattern_generator.cpp:405-433."""
    j = np.arange(height, dtype=np.float64)
    s = np.sin(j / height * math.pi)
    r = (s * (color & 0xFF) / 0xFF * 0xFFFF).astype(np.uint16)
    g = (s * ((color >> 8) & 0xFF) / 0xFF * 0xFFFF).astype(np.uint16)
    b = (s * ((color >> 16) & 0xFF) / 0xFF * 0xFFFF).astype(np.uint16)
    out = np.zeros((height, width, 3), dtype=np.uint16)
    out[..., 0] = r[:, None]
    out[..., 1] = g[:, None]
    out[..., 2] = b[:, None]
    return out.reshape(height, width * 3).view(np.uint8).reshape(height, width * 6)


def _gradient2_rg48(width: int, height: int, val_max: int) -> np.ndarray:
    """ref: image_pattern_gradient2 (horizontal ramp to val_max, 16-bit gray)."""
    x = (np.arange(width, dtype=np.float64) / max(width - 1, 1) * val_max).astype(np.uint16)
    out = np.zeros((height, width, 3), dtype=np.uint16)
    out[:] = x[None, :, None]
    return out.reshape(height, width * 3).view(np.uint8).reshape(height, width * 6)


def _noise_rg48(width: int, height: int, rng: np.random.Generator) -> np.ndarray:
    return rng.integers(0, 1 << 16, size=(height, width * 3), dtype=np.uint32).astype(np.uint16).view(np.uint8).reshape(height, width * 6)


def _rgba_words_to_bytes(buf: np.ndarray) -> np.ndarray:
    h, w = buf.shape
    return buf.astype("<u4").view(np.uint8).reshape(h, w * 4)


def generate_pattern(
    width: int,
    height: int,
    codec: Codec,
    pattern: str = "bars",
    seed: int = 0,
    device="cuda",
) -> torch.Tensor:
    """A test pattern as a packed uint8 frame [H, linesize] for ``codec``
    on ``device`` (the card unless the caller names another)."""
    device = get_device(device)
    name, _, cfg = pattern.partition("=")
    rng = np.random.default_rng(seed)

    if name in ("bars", "ebu_bars", "smpte_bars", "blank", "gray", "uv_plane"):
        if name == "bars":
            words = _bars(width, height)
        elif name == "ebu_bars":
            words = _ebu_smpte_bars(width, height, 0xFF, 8)
        elif name == "smpte_bars":
            words = _smpte_bars(width, height)
        elif name == "blank":
            color = int(cfg, 0) if cfg else 0xFF000000
            words = np.full((height, width), color, dtype=np.uint32)
        elif name == "gray":
            words = np.full((height, width), 0xFF808080, dtype=np.uint32)
        else:  # uv_plane: chroma sweep (ref :464)
            u = (np.arange(width) * 255 // max(width - 1, 1)).astype(np.uint32)
            v = (np.arange(height) * 255 // max(height - 1, 1)).astype(np.uint32)
            y = np.uint32(0x80)
            # mid-gray + UV ramp in RGB space, as the JAX package draws it
            words = (0xFF000000 | u[None, :] | (y << 8) | (v[:, None] << 16)).astype(np.uint32)
        src = _rgba_words_to_bytes(words)
        src_codec = Codec.RGBA
    elif name in ("gradient", "gradient2", "noise"):
        if name == "gradient":
            color = int(cfg, 0) if cfg else 0xFF
            src = _gradient_rg48(width, height, color)
        elif name == "gradient2":
            src = _gradient2_rg48(width, height, int(cfg, 0) if cfg else 0xFFFF)
        else:
            src = _noise_rg48(width, height, rng)
        src_codec = Codec.RG48
    else:
        raise ValueError(f"unknown pattern {name!r}")

    return convert_to(torch.as_tensor(src, device=device), src_codec, codec, width)


def convert_to(src: torch.Tensor, src_codec: Codec, dst_codec: Codec, width: int) -> torch.Tensor:
    """Convert via the registry on ``src``'s device, with a one-hop
    intermediate if needed (same role as testcard_convert_buffer,
    testcard_common.c)."""
    if src_codec == dst_codec:
        return src
    if pixfmt.get_decoder_from_to(src_codec, dst_codec):
        return pixfmt.convert_frame(src, width, src_codec, dst_codec)
    # one intermediate hop (e.g. RGBA -> UYVY -> v210)
    for mid in (Codec.UYVY, Codec.RG48, Codec.Y416, Codec.RGBA, Codec.RGB):
        if pixfmt.get_decoder_from_to(src_codec, mid) and pixfmt.get_decoder_from_to(mid, dst_codec):
            tmp = pixfmt.convert_frame(src, width, src_codec, mid)
            return pixfmt.convert_frame(tmp, width, mid, dst_codec)
    raise ValueError(f"cannot convert pattern from {src_codec.name} to {dst_codec.name}")
