"""Fixed-point color-space coefficients (BT.601/709/2020/P3).

The port's own copy of ``ultragrid_tpu/ops/color.py`` (plain Python, no
tensors), so that the port imports nothing of the JAX package;
``tests/test_torch_pixfmt.py`` holds every value here equal to the
reference's.  Re-derivation of the reference's integer coefficient tables
(ref: src/color_space.{h,c}; COMP_BASE=14 ``src/color_space.h:71``, the
COEFFS()/SCALED() macros ``src/color_space.c:46-128``): the same
double-precision formulas and truncation-toward-zero casts, so the integer
tables are bit-identical with the reference's.

Conventions (limited-range YCbCr, full-range SDI RGB):
  * ``y  = (r*y_r + g*y_g + b*y_b) >> COMP_BASE  + (1 << (depth-4))``
  * ``cb = (r*cb_r + g*cb_g + b*cb_b) >> COMP_BASE + (1 << (depth-1))``
  * ``r  = (y_scale*(y - (1<<(depth-4))) + (cr - (1<<(depth-1)))*r_cr) >> COMP_BASE``
  etc., all in int32 with arithmetic shifts.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import lru_cache

__all__ = [
    "COMP_BASE",
    "Colorspace",
    "ColorCoeffs",
    "compute_color_coeffs",
    "get_color_coeffs",
    "KR_601", "KB_601", "KR_709", "KB_709", "KR_2020", "KB_2020", "KR_P3", "KB_P3",
    "limit_lo", "limit_hi_y", "limit_hi_cbcr", "full_foot", "full_head",
]

COMP_BASE = 14  # ref: src/color_space.h:71 (32-bit comp_type_t)

KR_601, KB_601 = 0.299, 0.114
KR_709, KB_709 = 0.212639, 0.072192
KR_2020, KB_2020 = 0.262700, 0.059302
KR_P3, KB_P3 = 0.228975, 0.079287

_C_EPS = 0.5  # ref: src/color_space.c:55 (limited-range build)


class Colorspace(enum.IntEnum):
    DFL = 0
    CS_601 = 1
    CS_709 = 2


@dataclasses.dataclass(frozen=True)
class ColorCoeffs:
    """Integer coefficient set (ref: struct color_coeffs, src/color_space.h:135-148)."""

    y_r: int
    y_g: int
    y_b: int
    cb_r: int
    cb_g: int
    cb_b: int
    cr_r: int
    cr_g: int
    cr_b: int
    y_scale: int
    r_cr: int
    g_cb: int
    g_cr: int
    b_cb: int


def _trunc(x: float) -> int:
    """C-style (comp_type_t) cast: truncate toward zero."""
    return int(x)  # python int() truncates toward zero, same as C cast


def _scaled(x: float) -> int:
    sign = 1.0 if x > 0 else -1.0
    return _trunc(x * (1 << COMP_BASE) + sign * _C_EPS)


def _y_limit(depth: int) -> float:
    if depth == 0:
        return 1.0
    return 219.0 * (1 << (depth - 8)) / ((1 << depth) - 1)


def _cbcr_limit(depth: int) -> float:
    if depth == 0:
        return 1.0
    return 224.0 * (1 << (depth - 8)) / ((1 << depth) - 1)


@lru_cache(maxsize=None)
def compute_color_coeffs(kr: float, kb: float, ycbcr_bit_depth: int) -> ColorCoeffs:
    """Replicates COEFFS() (ref: src/color_space.c:117-128). depth 0 = full range."""
    kg = 1.0 - kr - kb
    d = 2.0 * (kr + kg)
    e = 2.0 * (1.0 - kr)
    yl = _y_limit(ycbcr_bit_depth)
    cl = _cbcr_limit(ycbcr_bit_depth)
    b = 1 << COMP_BASE
    return ColorCoeffs(
        y_r=_trunc(kr * yl * b + _C_EPS),
        y_g=_trunc(kg * yl * b + _C_EPS),
        y_b=_trunc(kb * yl * b + _C_EPS),
        cb_r=_trunc(-kr / d * cl * b - _C_EPS),
        cb_g=_trunc(-kg / d * cl * b - _C_EPS),
        cb_b=_trunc((1.0 - kb) / d * cl * b + _C_EPS),
        cr_r=_trunc((1.0 - kr) / e * cl * b - _C_EPS),
        cr_g=_trunc(-kg / e * cl * b - _C_EPS),
        cr_b=_trunc(-kb / e * cl * b + _C_EPS),
        y_scale=_scaled(1.0 / yl),
        r_cr=_scaled(2.0 * (1.0 - kr) / cl),
        g_cb=_scaled((-kb * (2.0 * (kr + kg)) / kg) / cl),
        g_cr=_scaled((-kr * (2.0 * (1.0 - kr)) / kg) / cl),
        b_cb=_scaled((2.0 * (kr + kg)) / cl),
    )


_DEFAULT_CS = Colorspace.CS_709  # ref: BT.709 default, src/color_space.c:186-191


def set_default_cs(cs: Colorspace) -> None:
    global _DEFAULT_CS
    _DEFAULT_CS = cs


def get_default_cs() -> Colorspace:
    return _DEFAULT_CS


def get_color_coeffs(cs: Colorspace, ycbcr_bit_depth: int) -> ColorCoeffs:
    """BT.601 or BT.709 coefficients at the given limited-range depth.

    ``ycbcr_bit_depth=0`` selects full-range scaling
    (ref: get_color_coeffs, src/color_space.c:149-184).
    """
    if cs == Colorspace.DFL:
        cs = _DEFAULT_CS
    if cs == Colorspace.CS_601:
        kr, kb = KR_601, KB_601
    else:
        kr, kb = KR_709, KB_709
    if ycbcr_bit_depth not in (0, 8, 10, 12, 16):
        raise ValueError(f"unsupported YCbCr depth {ycbcr_bit_depth}")
    return compute_color_coeffs(kr, kb, ycbcr_bit_depth)


# Range limits (ref: src/color_space.h:84-98)

def limit_lo(depth: int) -> int:
    return 1 << (depth - 4)


def limit_hi_y(depth: int) -> int:
    return 235 * (1 << (depth - 8))


def limit_hi_cbcr(depth: int) -> int:
    return 240 * (1 << (depth - 8))


def full_foot(depth: int) -> int:
    return 1 << (depth - 8)


def full_head(depth: int) -> int:
    return (255 << (depth - 8)) - 1
