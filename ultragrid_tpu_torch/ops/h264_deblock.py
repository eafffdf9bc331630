"""H.264 in-loop deblocking filter (spec clause 8.7), frame macroblocks,
4:2:0, 4x4 transform only — exactly the baseline-profile world the own
decoder covers.

This is what lets `ops/h264_dec.py` decode DEFAULT libx264 output
(deblocking enabled) sample-exact, instead of requiring
`x264opts=no-deblock` streams.  The reference reaches deblocked H.264
through libavcodec (src/video_decompress/libavcodec.c);
this module is the from-scratch equivalent for the own-codec family.

Model: the slice decoders reconstruct UNFILTERED planes (intra prediction
reads unfiltered neighbours, 8.3) and record per-MB filter inputs in a
`DeblockCtx`; `deblock_frame` then applies 8.7 over the whole picture in
macroblock raster order — vertical edges left-to-right first, then
horizontal edges top-to-bottom, each edge reading the partially-filtered
state exactly as the spec's in-place process does.
"""

from __future__ import annotations

import numpy as np

# Table 8-16: alpha / beta thresholds indexed by indexA / indexB (0..51)
_ALPHA = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
       40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
       226, 255, 255],
    np.int64,
)
_BETA = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
       11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    np.int64,
)
# Table 8-17: tc0 for bS = 1, 2, 3 (rows) by indexA (cols).  Byte-verified
# against libx264's rodata copy of the ISO table (tests/test_h264.py
# deblock-table drift check); an earlier transcription had bS=1 starting
# one step too early (indexA 21 vs 23), which showed up only as +/-1
# chroma deblock deltas on dense (qp<=24) inter streams.
_TC0 = np.array(
    [
        [0] * 16
        + [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
           3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13],
        [0] * 16
        + [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3,
           3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11, 12, 13, 15, 17],
        [0] * 16
        + [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4,
           5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 23, 25],
    ],
    np.int64,
)

# QPc mapping (Table 8-15), indexed by clipped qPi 0..51
_CHROMA_QP = np.array(
    list(range(30)) + [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                       37, 37, 37, 38, 38, 38, 39, 39, 39, 39],
    np.int64,
)


class DeblockCtx:
    """Per-frame filter inputs, filled in by the slice decoders."""

    def __init__(self, mbw: int, mbh: int, chroma_qp_off: int):
        self.mbw, self.mbh = mbw, mbh
        self.chroma_qp_off = chroma_qp_off
        self.intra = np.zeros((mbh, mbw), bool)
        self.ipcm = np.zeros((mbh, mbw), bool)
        self.qp = np.zeros((mbh, mbw), np.int64)
        # per-4x4 luma nonzero-coefficient flags (frame-wide accumulation)
        self.nnz = np.zeros((mbh * 4, mbw * 4), np.int64)
        # motion at 4x4 granularity (partition support, spec 6.4.11);
        # refs/refs1 hold PICTURE IDS per prediction list (-1 = unused) —
        # B blocks may carry two (picture, mv) pairs and 8.7.2.1 compares
        # the SETS, not list slots
        self.mvs = np.zeros((mbh * 4, mbw * 4, 2), np.int64)
        self.refs = np.full((mbh * 4, mbw * 4), -1, np.int64)
        self.mvs1 = np.zeros((mbh * 4, mbw * 4, 2), np.int64)
        self.refs1 = np.full((mbh * 4, mbw * 4), -1, np.int64)
        self.slice_id = np.full((mbh, mbw), -1, np.int64)
        # per-MB copy of the owning slice's deblock parameters
        self.idc = np.ones((mbh, mbw), np.int64)  # 1 = filter off
        self.offa = np.zeros((mbh, mbw), np.int64)
        self.offb = np.zeros((mbh, mbw), np.int64)
        self.decoded = np.zeros((mbh, mbw), bool)
        # High profile: per-MB transform_size_8x8_flag — gates which
        # internal luma edges exist and widens the bS "coded" test to the
        # containing 8x8 block (spec 8.7 / 8.7.2.1)
        self.t8x8 = np.zeros((mbh, mbw), bool)

    @property
    def any_enabled(self) -> bool:
        return bool(np.any(self.decoded & (self.idc != 1)))


def _clip3(lo, hi, x):
    return np.minimum(np.maximum(x, lo), hi)


def _filter_edge(seg: np.ndarray, bs: np.ndarray, index_a: int,
                 index_b: int, chroma: bool) -> np.ndarray:
    """Filter one edge (8.7.2.3/8.7.2.4).  seg is [n, 8] int64 rows of
    [p3 p2 p1 p0 q0 q1 q2 q3]; bs is [n].  Returns the filtered seg."""
    alpha = int(_ALPHA[index_a])
    beta = int(_BETA[index_b])
    p3, p2, p1, p0 = seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3]
    q0, q1, q2, q3 = seg[:, 4], seg[:, 5], seg[:, 6], seg[:, 7]

    filt = (bs > 0) & (np.abs(p0 - q0) < alpha) \
        & (np.abs(p1 - p0) < beta) & (np.abs(q1 - q0) < beta)
    if not filt.any():
        return seg
    ap = np.abs(p2 - p0) < beta
    aq = np.abs(q2 - q0) < beta

    # --- bS < 4 (8.7.2.3) ---
    tc0 = _TC0[np.clip(bs, 1, 3) - 1, index_a]
    tc = tc0 + 1 if chroma else tc0 + ap.astype(np.int64) + aq.astype(np.int64)
    delta = _clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3)
    p0n = np.clip(p0 + delta, 0, 255)
    q0n = np.clip(q0 - delta, 0, 255)
    if not chroma:
        p1n = np.where(ap, p1 + _clip3(-tc0, tc0,
                       (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1), p1)
        q1n = np.where(aq, q1 + _clip3(-tc0, tc0,
                       (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1), q1)
    else:
        p1n, q1n = p1, q1
    p2n, q2n = p2, q2

    # --- bS == 4 (8.7.2.4) ---
    if chroma:
        p0s = (2 * p1 + p0 + q1 + 2) >> 2
        q0s = (2 * q1 + q0 + p1 + 2) >> 2
        p1s, p2s, q1s, q2s = p1, p2, q1, q2
    else:
        small = np.abs(p0 - q0) < ((alpha >> 2) + 2)
        sp = small & ap
        p0s = np.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                       (2 * p1 + p0 + q1 + 2) >> 2)
        p1s = np.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
        p2s = np.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
        sq = small & aq
        q0s = np.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                       (2 * q1 + q0 + p1 + 2) >> 2)
        q1s = np.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
        q2s = np.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    strong = bs == 4
    out = seg.copy()

    def pick(norm, strg, orig):
        return np.where(filt, np.where(strong, strg, norm), orig)

    out[:, 1] = pick(p2n, p2s, p2)
    out[:, 2] = pick(p1n, p1s, p1)
    out[:, 3] = pick(p0n, p0s, p0)
    out[:, 4] = pick(q0n, q0s, q0)
    out[:, 5] = pick(q1n, q1s, q1)
    out[:, 6] = pick(q2n, q2s, q2)
    return out


def _bs_edge(ctx: DeblockCtx, pmb, qmb, pblocks, qblocks,
             mb_edge: bool) -> np.ndarray:
    """bS for the 4 4x4-block groups along one edge (8.7.2.1): intra MBs
    force 4 (MB edge) / 3 (internal); else per-block coded-coefficient
    (2) and reference/motion-difference (1) rules at 4x4 granularity."""
    if ctx.intra[pmb] or ctx.intra[qmb]:
        return np.full(4, 4 if mb_edge else 3, np.int64)

    def coded(b, mb):
        # with the 8x8 transform the "contains nonzero coefficients" test
        # applies to the 8x8 transform block containing the 4x4 (8.7.2.1)
        if ctx.t8x8[mb]:
            gy0, gx0 = b[0] & ~1, b[1] & ~1
            return bool(ctx.nnz[gy0:gy0 + 2, gx0:gx0 + 2].any())
        return bool(ctx.nnz[b])

    def pairs(b):
        out = []
        if ctx.refs[b] >= 0:
            out.append((int(ctx.refs[b]),
                        int(ctx.mvs[b][0]), int(ctx.mvs[b][1])))
        if ctx.refs1[b] >= 0:
            out.append((int(ctx.refs1[b]),
                        int(ctx.mvs1[b][0]), int(ctx.mvs1[b][1])))
        return out

    def far(a, b):
        return abs(a[1] - b[1]) >= 4 or abs(a[2] - b[2]) >= 4

    def motion_differs(pp, qq):
        """8.7.2.1 motion rules over the per-block (picture, mv) sets."""
        if len(pp) != len(qq):
            return True  # different number of motion vectors
        if not pp:
            return False
        if len(pp) == 1:
            return pp[0][0] != qq[0][0] or far(pp[0], qq[0])
        prefs = sorted(p[0] for p in pp)
        if prefs != sorted(q[0] for q in qq):
            return True  # different reference pictures used
        if pp[0][0] != pp[1][0]:
            # two distinct pictures: align the comparison by picture
            q_by_ref = {q[0]: q for q in qq}
            return any(far(p, q_by_ref[p[0]]) for p in pp)
        # both predictions from ONE picture: bS stays 0 only if SOME
        # assignment of the two vectors keeps every difference small
        straight = not far(pp[0], qq[0]) and not far(pp[1], qq[1])
        crossed = not far(pp[0], qq[1]) and not far(pp[1], qq[0])
        return not (straight or crossed)

    bs = np.zeros(4, np.int64)
    for i, (pb, qb) in enumerate(zip(pblocks, qblocks)):
        if coded(pb, pmb) or coded(qb, qmb):
            bs[i] = 2
        elif motion_differs(pairs(pb), pairs(qb)):
            bs[i] = 1
    return bs


def deblock_frame(y: np.ndarray, cb: np.ndarray, cr: np.ndarray,
                  ctx: DeblockCtx):
    """Apply 8.7 in place over full (uncropped, MB-aligned) uint8 planes.
    Returns the same arrays (now filtered)."""
    mbw, mbh = ctx.mbw, ctx.mbh
    yl = y.astype(np.int64)
    cbl = cb.astype(np.int64)
    crl = cr.astype(np.int64)
    qpy = np.where(ctx.ipcm, 0, ctx.qp)
    qpc = _CHROMA_QP[np.clip(qpy + ctx.chroma_qp_off, 0, 51)]

    for my in range(mbh):
        for mx in range(mbw):
            if not ctx.decoded[my, mx] or ctx.idc[my, mx] == 1:
                continue
            offa = int(ctx.offa[my, mx])
            offb = int(ctx.offb[my, mx])
            sid = ctx.slice_id[my, mx]

            def mb_edge_ok(pmy, pmx):
                if not ctx.decoded[pmy, pmx]:
                    return False
                if ctx.idc[my, mx] == 2 and ctx.slice_id[pmy, pmx] != sid:
                    return False
                return True

            def indices(qp_p, qp_q):
                qpav = (int(qp_p) + int(qp_q) + 1) >> 1
                return (min(max(qpav + offa, 0), 51),
                        min(max(qpav + offb, 0), 51))

            # ---- vertical luma edges (filtered left to right) ----
            # transform_size_8x8_flag removes the internal edges at 4, 12
            luma_edges = (0, 8) if ctx.t8x8[my, mx] else (0, 4, 8, 12)
            for ex in luma_edges:
                x = mx * 16 + ex
                gx = x // 4
                groups_q = [(my * 4 + i, gx) for i in range(4)]
                if ex == 0:
                    if mx == 0 or not mb_edge_ok(my, mx - 1):
                        continue
                    groups_p = [(my * 4 + i, gx - 1) for i in range(4)]
                    bs4 = _bs_edge(ctx, (my, mx - 1), (my, mx),
                                   groups_p, groups_q, True)
                    ia, ib = indices(qpy[my, mx - 1], qpy[my, mx])
                else:
                    groups_p = [(my * 4 + i, gx - 1) for i in range(4)]
                    bs4 = _bs_edge(ctx, (my, mx), (my, mx),
                                   groups_p, groups_q, False)
                    ia, ib = indices(qpy[my, mx], qpy[my, mx])
                if not bs4.any():
                    continue
                seg = yl[my * 16:my * 16 + 16, x - 4:x + 4]
                bs = np.repeat(bs4, 4)
                yl[my * 16:my * 16 + 16, x - 4:x + 4] = _filter_edge(
                    seg, bs, ia, ib, chroma=False)

            # ---- vertical chroma edges (chroma x = 0, 4 <-> luma 0, 8) --
            for ex, lex in ((0, 0), (4, 8)):
                xc = mx * 8 + ex
                if lex == 0:
                    if mx == 0 or not mb_edge_ok(my, mx - 1):
                        continue
                    groups_p = [(my * 4 + i, mx * 4 - 1) for i in range(4)]
                    groups_q = [(my * 4 + i, mx * 4) for i in range(4)]
                    bs4 = _bs_edge(ctx, (my, mx - 1), (my, mx),
                                   groups_p, groups_q, True)
                    ia, ib = indices(qpc[my, mx - 1], qpc[my, mx])
                else:
                    gx = mx * 4 + 2
                    groups_p = [(my * 4 + i, gx - 1) for i in range(4)]
                    groups_q = [(my * 4 + i, gx) for i in range(4)]
                    bs4 = _bs_edge(ctx, (my, mx), (my, mx),
                                   groups_p, groups_q, False)
                    ia, ib = indices(qpc[my, mx], qpc[my, mx])
                if not bs4.any():
                    continue
                bs = np.repeat(bs4, 2)
                for pl in (cbl, crl):
                    seg = pl[my * 8:my * 8 + 8, xc - 4:xc + 4]
                    pl[my * 8:my * 8 + 8, xc - 4:xc + 4] = _filter_edge(
                        seg, bs, ia, ib, chroma=True)

            # ---- horizontal luma edges (filtered top to bottom) ----
            for ey in luma_edges:
                yy = my * 16 + ey
                gy = yy // 4
                groups_q = [(gy, mx * 4 + i) for i in range(4)]
                if ey == 0:
                    if my == 0 or not mb_edge_ok(my - 1, mx):
                        continue
                    groups_p = [(gy - 1, mx * 4 + i) for i in range(4)]
                    bs4 = _bs_edge(ctx, (my - 1, mx), (my, mx),
                                   groups_p, groups_q, True)
                    ia, ib = indices(qpy[my - 1, mx], qpy[my, mx])
                else:
                    groups_p = [(gy - 1, mx * 4 + i) for i in range(4)]
                    bs4 = _bs_edge(ctx, (my, mx), (my, mx),
                                   groups_p, groups_q, False)
                    ia, ib = indices(qpy[my, mx], qpy[my, mx])
                if not bs4.any():
                    continue
                seg = yl[yy - 4:yy + 4, mx * 16:mx * 16 + 16].T
                bs = np.repeat(bs4, 4)
                out = _filter_edge(seg, bs, ia, ib, chroma=False)
                yl[yy - 4:yy + 4, mx * 16:mx * 16 + 16] = out.T

            # ---- horizontal chroma edges ----
            for ey, ley in ((0, 0), (4, 8)):
                yc = my * 8 + ey
                if ley == 0:
                    if my == 0 or not mb_edge_ok(my - 1, mx):
                        continue
                    groups_p = [(my * 4 - 1, mx * 4 + i) for i in range(4)]
                    groups_q = [(my * 4, mx * 4 + i) for i in range(4)]
                    bs4 = _bs_edge(ctx, (my - 1, mx), (my, mx),
                                   groups_p, groups_q, True)
                    ia, ib = indices(qpc[my - 1, mx], qpc[my, mx])
                else:
                    gy = my * 4 + 2
                    groups_p = [(gy - 1, mx * 4 + i) for i in range(4)]
                    groups_q = [(gy, mx * 4 + i) for i in range(4)]
                    bs4 = _bs_edge(ctx, (my, mx), (my, mx),
                                   groups_p, groups_q, False)
                    ia, ib = indices(qpc[my, mx], qpc[my, mx])
                if not bs4.any():
                    continue
                bs = np.repeat(bs4, 2)
                for pl in (cbl, crl):
                    seg = pl[yc - 4:yc + 4, mx * 8:mx * 8 + 8].T
                    out = _filter_edge(seg, bs, ia, ib, chroma=True)
                    pl[yc - 4:yc + 4, mx * 8:mx * 8 + 8] = out.T

    y[:] = yl.astype(y.dtype)
    cb[:] = cbl.astype(cb.dtype)
    cr[:] = crl.astype(cr.dtype)
    return y, cb, cr
