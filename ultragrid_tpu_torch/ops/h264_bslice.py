"""B-slice decode math shared by the CAVLC and CABAC slice decoders.

Pure helpers (no slice state): POC-sorted reference list initialization
(8.2.4.2.3), implicit weighted-bipred weights (8.4.2.3.1), and the
MB-level part of spatial direct prediction (8.4.1.2.2/8.4.1.2.3).
Reference role: the B-frame half of the decode path the reference fills
via libavcodec (src/video_decompress/libavcodec.c).
"""

from __future__ import annotations

from typing import List, Tuple


def b_list_init(metas, cur_poc: int) -> Tuple[List[int], List[int]]:
    """Initial RefPicList0/1 for a B slice from short-term refs
    (8.2.4.2.3): L0 = {poc < cur, descending} + {poc > cur, ascending};
    L1 = the mirror; if the lists are equal with >= 2 entries, L1 swaps
    its first two."""
    idx = list(range(len(metas)))
    before = sorted((i for i in idx if metas[i]["poc"] < cur_poc),
                    key=lambda i: -metas[i]["poc"])
    after = sorted((i for i in idx if metas[i]["poc"] > cur_poc),
                   key=lambda i: metas[i]["poc"])
    l0 = before + after
    l1 = after + before
    if len(l1) >= 2 and l0 == l1:
        l1 = [l1[1], l1[0]] + l1[2:]
    return l0, l1


def _cdiv(a: int, b: int) -> int:
    """Spec '/' — integer division truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip3(lo, hi, x):
    return lo if x < lo else (hi if x > hi else x)


def implicit_weights(cur_poc: int, poc0: int, poc1: int) -> Tuple[int, int]:
    """Implicit bipred (w0, w1), logWD fixed at 5 (8.4.2.3.1)."""
    if poc0 == poc1:
        return 32, 32
    tb = _clip3(-128, 127, cur_poc - poc0)
    td = _clip3(-128, 127, poc1 - poc0)
    tx = _cdiv(16384 + abs(_cdiv(td, 2)), td)
    dsf = _clip3(-1024, 1023, (tb * tx + 32) >> 6)
    w1 = dsf >> 2
    if w1 < -64 or w1 > 128:
        return 32, 32
    return 64 - w1, w1


def min_positive(a: int, b: int) -> int:
    """MinPositive (8.4.1.2.2): the smaller non-negative, else the max."""
    if a >= 0 and b >= 0:
        return min(a, b)
    return max(a, b)


def direct_ref_indices(ref_grid0, ref_grid1, gy0: int, gx0: int,
                       my0: int, mbw: int, dec4) -> Tuple[int, int]:
    """Spatial direct refIdxL0/L1 for the MB at 4x4-grid (gy0, gx0):
    MinPositive over the A/B/C neighbour partitions' indices per list
    (8.4.1.2.2; unavailable -> -1)."""
    def nb(grid, y, x, ok):
        return int(grid[y, x]) if ok and dec4[y, x] else -1

    has_a = gx0 > 0
    has_b = gy0 > my0 * 4
    cx = gx0 + 4
    if has_b and cx < mbw * 4:
        c_pos = (gy0 - 1, cx)
    elif has_b and has_a:
        c_pos = (gy0 - 1, gx0 - 1)
    else:
        c_pos = None
    out = []
    for grid in (ref_grid0, ref_grid1):
        ra = nb(grid, gy0, gx0 - 1, has_a)
        rb = nb(grid, gy0 - 1, gx0, has_b)
        rc = nb(grid, *c_pos, True) if c_pos is not None else -1
        out.append(min_positive(ra, min_positive(rb, rc)))
    return out[0], out[1]


def col_zero(colmeta, gy: int, gx: int) -> bool:
    """colZeroFlag for one 4x4 (8.4.1.2.2): the colocated block in
    RefPicList1[0] uses ref index 0 with a near-zero MV."""
    if colmeta is None:
        return False
    if int(colmeta["refcol"][gy, gx]) != 0:
        return False
    mv = colmeta["mvcol"][gy, gx]
    return abs(int(mv[0])) <= 1 and abs(int(mv[1])) <= 1


def direct_corner(gy0: int, gx0: int, q: int,
                  direct_8x8: bool, dy: int, dx: int) -> Tuple[int, int]:
    """Colocated 4x4 position for quadrant ``q``'s block at (dy, dx):
    with direct_8x8_inference the OUTER corner 4x4 of the quadrant
    (8.4.1.2.2), else the block itself."""
    if not direct_8x8:
        return gy0 + (q // 2) * 2 + dy, gx0 + (q % 2) * 2 + dx
    cy = 0 if q < 2 else 3
    cx = 0 if q % 2 == 0 else 3
    return gy0 + cy, gx0 + cx
