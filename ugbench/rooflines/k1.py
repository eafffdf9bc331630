"""Kernel K1 (``csrc/jpeg_encode.cu``): the least time a JPEG encode's
device half can take, whatever implements it.

Bytes: each frame byte read once and each coded byte written once.
Operations per 8x8 block: the fewest a known fast 2-D DCT takes (Feig and
Winograd, 1992: 54 multiplications, 462 additions and 6 shifts, its output
scaling folded into the quantisation), the 64 multiplications of the
quantisation, and one for the level shift (folded into the DC term).  A
4:2:2 frame from UYVY has no colour conversion and 2 * w * h / 64 blocks.
"""

from ugbench import peaks

FLOP_PER_BLOCK = 54 + 462 + 6 + 64 + 1


def min_seconds(width: int, height: int, coded_bytes: int, bytes_per_pixel: int = 2) -> float:
    blocks = 2 * width * height // 64
    flops = blocks * FLOP_PER_BLOCK
    nbytes = width * height * bytes_per_pixel + coded_bytes
    return max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES)
