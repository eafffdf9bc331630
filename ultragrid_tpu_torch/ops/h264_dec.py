"""Own H.264 baseline intra decoder (CAVLC; foreign streams supported).

Counterpart of the own encoder in ops/h264.py, so the framework can both
produce AND consume H.264 without FFmpeg (role: src/video_decompress/
libavcodec.c).  Implements the *decoder-side* spec math — CAVLC parsing,
dequantization (LevelScale tables), inverse Hadamard + inverse core
transform, and intra prediction from RECONSTRUCTED neighbors — so its
output must match any conformant decoder bit-exactly; tests assert
sample-exact agreement with libavcodec both on our encoder's streams and
on libx264-produced baseline intra streams.

Supported: baseline profile I/IDR slices, mb types I_PCM, I_16x16 (all
four luma prediction modes) and I_4x4 (all nine prediction modes), all
four chroma prediction modes, per-MB QP deltas, CAVLC residual —
i.e. everything a baseline intra encoder can emit except deblocking
(streams must signal deblocking disabled).  Anything else raises
``UnsupportedStream``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.ops import h264 as H


class UnsupportedStream(Exception):
    pass


# ---------------------------------------------------------------------------
# bit reading
# ---------------------------------------------------------------------------


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def u(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise UnsupportedStream("bad exp-golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def more_rbsp_data(self) -> bool:
        """True while bits remain before the rbsp_stop_one_bit (7.2)."""
        last = len(self.data) - 1
        while last >= 0 and self.data[last] == 0:
            last -= 1
        if last < 0:
            return False
        stop = last * 8 + (
            7 - ((self.data[last] & -self.data[last]).bit_length() - 1))
        return self.pos < stop


def _unepb(data: bytes) -> bytes:
    """Remove emulation-prevention 0x03 bytes."""
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(data):
        b = data[i]
        if zeros >= 2 and b == 3 and i + 1 < len(data) and data[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def split_nals(bs: bytes):
    """Annex-B -> [(nal_type, rbsp bytes)]."""
    return [(t, r) for t, _, r in split_nals_ref(bs)]


def split_nals_ref(bs: bytes):
    """Annex-B -> [(nal_type, nal_ref_idc, rbsp bytes)].  ref_idc drives
    DPB membership (nal_ref_idc == 0 pictures are never references —
    x264's non-pyramid B frames)."""
    out = []
    i = 0
    n = len(bs)
    starts = []
    while i < n - 3:
        if bs[i] == 0 and bs[i + 1] == 0 and (bs[i + 2] == 1 or (bs[i + 2] == 0 and i + 3 < n and bs[i + 3] == 1)):
            skip = 3 if bs[i + 2] == 1 else 4
            starts.append(i + skip)
            i += skip
        else:
            i += 1
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        # trim the next start code's leading zeros
        while e > s and bs[e - 1] == 0 and k + 1 < len(starts):
            e -= 1
        nal_type = bs[s] & 0x1F
        ref_idc = (bs[s] >> 5) & 3
        out.append((nal_type, ref_idc, _unepb(bs[s + 1 : e])))
    return out


# ---------------------------------------------------------------------------
# VLC decode tables (inverted from the encoder's spec tables)
# ---------------------------------------------------------------------------


def _invert(table):
    """{(a,b): (val,len)} -> {(len, val): (a, b)}"""
    return {(l, v): key for key, (v, l) in table.items()}


_ICT = {k: _invert(t) for k, t in (("0", H._CT0), ("2", H._CT2), ("4", H._CT4), ("c", H._CTC))}
_ITZ = {tc: {(l, v): tz for tz, (v, l) in row.items()} for tc, row in H._TZ.items()}
_ITZC = {tc: {(l, v): tz for tz, (v, l) in row.items()} for tc, row in H._TZC.items()}
_IRB = {zl: {(l, v): r for r, (v, l) in row.items()} for zl, row in H._RB.items()}


def _read_vlc(r: BitReader, inv: Dict[Tuple[int, int], object], max_len: int = 16):
    v = 0
    for ln in range(1, max_len + 1):
        v = (v << 1) | r.u(1)
        hit = inv.get((ln, v))
        if hit is not None:
            return hit
    raise UnsupportedStream("vlc decode failed")


def decode_cavlc_block(r: BitReader, nC: int, max_coeffs: int) -> np.ndarray:
    """Read one CAVLC block -> zigzag-ordered coefficient array."""
    coeffs = np.zeros(max_coeffs, np.int64)
    if nC == -1:
        t1, total = _read_vlc(r, _ICT["c"])
    elif nC < 2:
        t1, total = _read_vlc(r, _ICT["0"])
    elif nC < 4:
        t1, total = _read_vlc(r, _ICT["2"])
    elif nC < 8:
        t1, total = _read_vlc(r, _ICT["4"])
    else:
        v = r.u(6)
        if v == 3:
            t1, total = 0, 0
        else:
            t1, total = v & 3, (v >> 2) + 1
    if total == 0:
        return coeffs
    levels = []
    for _ in range(t1):
        levels.append(-1 if r.u(1) else 1)
    suffix_len = 1 if (total > 10 and t1 < 3) else 0
    first = True
    for i in range(total - t1):
        prefix = 0
        while r.u(1) == 0:
            prefix += 1
            if prefix > 16:
                raise UnsupportedStream("bad level prefix")
        if suffix_len == 0:
            if prefix < 14:
                code = prefix
            elif prefix == 14:
                code = 14 + r.u(4)
            else:
                code = 30 + r.u(12)
        else:
            if prefix < 15:
                code = (prefix << suffix_len) | r.u(suffix_len)
            else:
                code = (15 << suffix_len) + r.u(12)
        if first and t1 < 3:
            code += 2
        first = False
        level = (code + 2) // 2 if code % 2 == 0 else -((code + 1) // 2)
        levels.append(level)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    # total_zeros
    if total < max_coeffs:
        if nC == -1:
            zeros = _read_vlc(r, _ITZC[total])
        else:
            zeros = _read_vlc(r, _ITZ[total])
    else:
        zeros = 0
    # runs (levels[] is rank order: rank0 = highest zigzag pos)
    runs = []
    zeros_left = zeros
    for i in range(total - 1):
        if zeros_left > 0:
            runs.append(_read_vlc(r, _IRB[min(zeros_left, 7)]))
            zeros_left -= runs[-1]
        else:
            runs.append(0)
    runs.append(zeros_left)  # implied zeros before the lowest coeff
    pos = total - 1 + zeros
    for i, level in enumerate(levels):
        coeffs[pos] = level
        if i < total - 1:
            pos -= 1 + runs[i]
    return coeffs


# ---------------------------------------------------------------------------
# dequant + inverse transforms (spec 8.5)
# ---------------------------------------------------------------------------

_V = [
    (10, 16, 13), (11, 18, 14), (13, 20, 16),
    (14, 23, 18), (16, 25, 20), (18, 29, 23),
]


def _vmat(qp: int) -> np.ndarray:
    vr = _V[qp % 6]
    return np.array([[vr[H._POSCLASS[r][c]] for c in range(4)] for r in range(4)],
                    np.int64)


def _itransform4(d: np.ndarray) -> np.ndarray:
    """Inverse core transform (rows then cols), WITHOUT the final >> 6."""
    def pass1(x):
        e0 = x[0] + x[2]
        e1 = x[0] - x[2]
        e2 = (x[1] >> 1) - x[3]
        e3 = x[1] + (x[3] >> 1)
        return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3])

    # spec 8.5.12.2: each ROW first (horizontal), then each column — the
    # >>1 terms make the order observable in the LSB
    h = pass1(d.T).T
    v = pass1(h)
    return v


def _ihadamard4(f: np.ndarray) -> np.ndarray:
    return H._H4 @ f.astype(np.int64) @ H._H4


def _dezigzag(zz: np.ndarray) -> np.ndarray:
    out = np.zeros(16, np.int64)
    out[H._ZZ_IDX] = zz
    return out.reshape(4, 4)


# coded_block_pattern me(v) mapping for intra MBs (spec Table 9-4)
_CBP_INTRA = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41,
]


# ---------------------------------------------------------------------------
# intra prediction (spec 8.3)
# ---------------------------------------------------------------------------


def _pred4x4(mode: int, t: Optional[np.ndarray], l: Optional[np.ndarray],
             tl: Optional[int]) -> np.ndarray:
    """4x4 luma prediction.  t: top samples p[0..7,-1] (top-right already
    replicated if unavailable), l: left p[-1,0..3], tl: p[-1,-1]."""
    p = np.zeros((4, 4), np.int64)
    if mode == 0:  # Vertical
        p[:] = t[None, :4]
    elif mode == 1:  # Horizontal
        p[:] = l[:, None]
    elif mode == 2:  # DC
        if t is not None and l is not None:
            p[:] = (int(t[:4].sum()) + int(l.sum()) + 4) >> 3
        elif t is not None:
            p[:] = (int(t[:4].sum()) + 2) >> 2
        elif l is not None:
            p[:] = (int(l.sum()) + 2) >> 2
        else:
            p[:] = 128
    elif mode == 3:  # Diagonal-Down-Left
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    p[y, x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
    elif mode == 4:  # Diagonal-Down-Right
        ext = np.array([l[3], l[2], l[1], l[0], tl, t[0], t[1], t[2], t[3]], np.int64)
        f = np.zeros(9, np.int64)
        for k in range(1, 8):
            f[k] = (ext[k - 1] + 2 * ext[k] + ext[k + 1] + 2) >> 2
        for y in range(4):
            for x in range(4):
                p[y, x] = f[(x - y) + 4]
    elif mode == 5:  # Vertical-Right
        def P(x, y):
            if y == -1:
                return tl if x == -1 else t[x]
            return l[y]
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (P(x - (y >> 1) - 2, -1) + 2 * P(x - (y >> 1) - 1, -1)
                               + P(x - (y >> 1), -1) + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    # l[-1] is the corner (p[-1,-1]), NOT a python wrap
                    def L(i):
                        return tl if i == -1 else l[i]
                    p[y, x] = (L(y - 1) + 2 * L(y - 2) + L(y - 3) + 2) >> 2
    elif mode == 6:  # Horizontal-Down
        def P(x, y):
            if x == -1:
                return tl if y == -1 else l[y]
            return t[x]
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 1) >> 1
                elif z >= 0:
                    p[y, x] = (P(-1, y - (x >> 1) - 2) + 2 * P(-1, y - (x >> 1) - 1)
                               + P(-1, y - (x >> 1)) + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    # t[-1] is the corner (p[-1,-1]), NOT a python wrap
                    def T(i):
                        return tl if i == -1 else t[i]
                    p[y, x] = (T(x - 1) + 2 * T(x - 2) + T(x - 3) + 2) >> 2
    elif mode == 7:  # Vertical-Left
        for y in range(4):
            for x in range(4):
                if y % 2 == 0:
                    p[y, x] = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1
                else:
                    p[y, x] = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                               + t[x + (y >> 1) + 2] + 2) >> 2
    elif mode == 8:  # Horizontal-Up
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z in (0, 2, 4):
                    p[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1
                elif z in (1, 3):
                    p[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                               + l[y + (x >> 1) + 2] + 2) >> 2
                elif z == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    p[y, x] = l[3]
    else:
        raise UnsupportedStream(f"intra4x4 mode {mode}")
    return p


def _pred16_plane(t: np.ndarray, l: np.ndarray, tl: int) -> np.ndarray:
    """I_16x16 plane prediction (spec 8.3.3.4)."""
    pfull_t = np.concatenate([[tl], t]).astype(np.int64)  # p[-1..15, -1]
    pfull_l = np.concatenate([[tl], l]).astype(np.int64)
    Hs = sum((x + 1) * (pfull_t[9 + x] - pfull_t[7 - x]) for x in range(8))
    Vs = sum((y + 1) * (pfull_l[9 + y] - pfull_l[7 - y]) for y in range(8))
    a = 16 * (int(l[15]) + int(t[15]))
    b = (5 * Hs + 32) >> 6
    c = (5 * Vs + 32) >> 6
    xs = np.arange(16, dtype=np.int64)
    pred = (a + b * (xs[None, :] - 7) + c * (xs[:, None] - 7) + 16) >> 5
    return np.clip(pred, 0, 255)


def _pred8_chroma_plane(t: np.ndarray, l: np.ndarray, tl: int) -> np.ndarray:
    """Chroma 8x8 plane prediction (spec 8.3.4.4, 4:2:0)."""
    pfull_t = np.concatenate([[tl], t]).astype(np.int64)
    pfull_l = np.concatenate([[tl], l]).astype(np.int64)
    Hs = sum((x + 1) * (pfull_t[5 + x] - pfull_t[3 - x]) for x in range(4))
    Vs = sum((y + 1) * (pfull_l[5 + y] - pfull_l[3 - y]) for y in range(4))
    a = 16 * (int(l[7]) + int(t[7]))
    b = (34 * Hs + 32) >> 6
    c = (34 * Vs + 32) >> 6
    xs = np.arange(8, dtype=np.int64)
    pred = (a + b * (xs[None, :] - 3) + c * (xs[:, None] - 3) + 16) >> 5
    return np.clip(pred, 0, 255)


# ---------------------------------------------------------------------------
# Intra_8x8 (High profile; transform/prediction math in ops/h264_8x8.py)
# ---------------------------------------------------------------------------


def luma_neighbors8(y, done4, mbw, my0, px, py):
    """Reference samples for the 8x8 block at pixel (px, py): UNFILTERED
    (t[0..15], l[0..7], tl) with top-right replication (8.3.2.1.1); the
    caller runs filter_refs8 before prediction.  None = unavailable."""
    gx, gy = px // 4, py // 4
    top = None
    if py > my0 * 16 and done4[gy - 1, gx] and done4[gy - 1, gx + 1]:
        t16 = np.empty(16, np.int64)
        t16[:8] = y[py - 1, px:px + 8]
        if gx + 2 < mbw * 4 and done4[gy - 1, gx + 2]:
            t16[8:] = y[py - 1, px + 8:px + 16]
        else:
            t16[8:] = y[py - 1, px + 7]
        top = t16
    left = None
    if px > 0 and done4[gy, gx - 1] and done4[gy + 1, gx - 1]:
        left = y[py:py + 8, px - 1].astype(np.int64)
    tl = None
    if top is not None and left is not None:
        tl = int(y[py - 1, px - 1])
    return top, left, tl


def read_intra8x8_modes_cavlc(r, mx, my, my0, i4mode, avail4):
    """Parse the four prev/rem Intra_8x8 prediction modes, updating the
    shared MxM mode grid (all four 4x4 cells of each 8x8 carry its mode,
    spec 8.3.1.1 / 8.3.2.1)."""
    modes = []
    for b in range(4):
        gx = mx * 4 + (b % 2) * 2
        gy = my * 4 + (b // 2) * 2
        ma = i4mode[gy, gx - 1] if gx > 0 and avail4[gy, gx - 1] else -1
        mb_ = i4mode[gy - 1, gx] if gy > my0 * 4 and avail4[gy - 1, gx] else -1
        pm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
        if ma < 0 or mb_ < 0:
            pm = 2
        if r.u(1):  # prev_intra8x8_pred_mode_flag
            m = pm
        else:
            rem = r.u(3)
            m = rem if rem < pm else rem + 1
        modes.append(m)
        i4mode[gy:gy + 2, gx:gx + 2] = m
        avail4[gy:gy + 2, gx:gx + 2] = True
    return modes


def decode_luma8x8_block_cavlc(r, b, mx, my, my0, nnz_l, nc_of, has):
    """One 8x8 luma residual in CAVLC: four interleaved 4x4 CAVLC blocks
    (7.3.5.3.2 — coeff i of sub-block k lands at 8x8 scan position
    4*i + k); per-sub-block TotalCoeff feeds the nC grid."""
    zz64 = np.zeros(64, np.int64)
    for k in range(4):
        bx, by = H._BLK_ORDER[b * 4 + k]
        gx, gy = mx * 4 + bx, my * 4 + by
        if not has:
            nnz_l[gy, gx] = 0
            continue
        nc = nc_of(nnz_l, gx, gy, my0 * 4)
        zz = decode_cavlc_block(r, nc, 16)
        nnz_l[gy, gx] = int(np.count_nonzero(zz))
        zz64[k::4] = zz
    return zz64


def recon_intra8x8_luma(y, done4, mbw, my0, mx, my, modes, zz64s, qp):
    """Reconstruct the four 8x8 luma blocks in decode order (prediction
    from already-reconstructed neighbours, filtered refs)."""
    from ultragrid_tpu_torch.ops.h264_8x8 import filter_refs8, pred8x8, recon_res8

    for b in range(4):
        gx = mx * 4 + (b % 2) * 2
        gy = my * 4 + (b // 2) * 2
        px, py = gx * 4, gy * 4
        top, left, tl = luma_neighbors8(y, done4, mbw, my0, px, py)
        ft, fl, ftl = filter_refs8(top, left, tl)
        pred = pred8x8(int(modes[b]), ft, fl, ftl)
        res = (recon_res8(zz64s[b], qp) if zz64s[b] is not None
               else np.zeros((8, 8), np.int64))
        y[py:py + 8, px:px + 8] = np.clip(pred + res, 0, 255)
        done4[gy:gy + 2, gx:gx + 2] = True


def chroma_pred_mb(plane, mx, my, my0, mode):
    """Chroma intra prediction for one MB (8.3.4), module-level twin of
    the slice decoders' closures for the shared intra-in-P paths."""
    x0, y0 = mx * 8, my * 8
    lcol = plane[y0:y0 + 8, x0 - 1].astype(np.int64) if mx > 0 else None
    trow = plane[y0 - 1, x0:x0 + 8].astype(np.int64) if my > my0 else None
    if mode == 0:  # DC per 4x4 sub-block (spec 8.3.4.1)
        preds = np.zeros((8, 8), np.int64)
        for by in range(2):
            for bx in range(2):
                lc = lcol[by * 4:by * 4 + 4] if lcol is not None else None
                tr = trow[bx * 4:bx * 4 + 4] if trow is not None else None
                use_l, use_t = lc is not None, tr is not None
                if bx == 1 and by == 0 and tr is not None:
                    use_l = False
                if bx == 0 and by == 1 and lc is not None:
                    use_t = False
                if use_l and use_t:
                    v = (int(lc.sum()) + int(tr.sum()) + 4) >> 3
                elif use_l:
                    v = (int(lc.sum()) + 2) >> 2
                elif use_t:
                    v = (int(tr.sum()) + 2) >> 2
                else:
                    v = 128
                preds[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = v
        return preds
    if mode == 1:  # Horizontal
        return np.repeat(lcol[:, None], 8, axis=1)
    if mode == 2:  # Vertical
        return np.repeat(trow[None, :], 8, axis=0)
    if mode == 3:  # Plane
        tl = int(plane[y0 - 1, x0 - 1])
        return _pred8_chroma_plane(trow, lcol, tl)
    raise UnsupportedStream(f"chroma pred mode {mode}")


def _decode_intra4x4_cavlc(r, mx, my, my0, qp, pps, mbw, y, chroma_planes,
                           nnz_l, nnz_c, nc_of, i4mode, avail4, done4):
    """Full Intra_4x4 macroblock (CAVLC) for intra-in-P slices; same
    syntax/reconstruction as the I-slice decoder's inline branch, with
    done4-gated sample availability (inter neighbours of the same slice
    are usable since constrained_intra_pred is 0)."""
    modes = np.zeros(16, np.int64)
    for bi, (bx, by) in enumerate(H._BLK_ORDER):
        gx, gy = mx * 4 + bx, my * 4 + by
        ma = i4mode[gy, gx - 1] if gx > 0 and avail4[gy, gx - 1] else -1
        mb_ = i4mode[gy - 1, gx] if gy > my0 * 4 and avail4[gy - 1, gx] else -1
        pm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
        if ma < 0 or mb_ < 0:
            pm = 2
        if r.u(1):  # prev_intra4x4_pred_mode_flag
            modes[bi] = pm
        else:
            rem = r.u(3)
            modes[bi] = rem if rem < pm else rem + 1
        i4mode[gy, gx] = modes[bi]
        avail4[gy, gx] = True
    chroma_mode = r.ue()
    cbp_code = r.ue()
    if cbp_code >= len(_CBP_INTRA):
        raise UnsupportedStream("bad coded_block_pattern")
    cbp = _CBP_INTRA[cbp_code]
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    if cbp_chroma == 3:
        raise UnsupportedStream("bad chroma cbp")
    if cbp:
        qp = qp + r.se()
    qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
    vy, vc = _vmat(qp), _vmat(qpc)
    for bi, (bx, by) in enumerate(H._BLK_ORDER):
        gx, gy = mx * 4 + bx, my * 4 + by
        px, py = gx * 4, gy * 4
        mode = int(modes[bi])
        # neighbours (same derivation as the I-slice closure)
        top = None
        if py > my0 * 16 and done4[gy - 1, gx]:
            t8 = np.empty(8, np.int64)
            t8[:4] = y[py - 1, px:px + 4]
            if mode in (3, 7) and gx + 1 < mbw * 4 and done4[gy - 1, gx + 1]:
                t8[4:] = y[py - 1, px + 4:px + 8]
            else:
                t8[4:] = y[py - 1, px + 3]
            top = t8
        left = None
        if px > 0 and done4[gy, gx - 1]:
            left = y[py:py + 4, px - 1].astype(np.int64)
        tl = None
        if top is not None and left is not None and px > 0 and py > my0 * 16:
            tl = int(y[py - 1, px - 1])
        pred = _pred4x4(mode, top, left, tl)
        if cbp_luma & (1 << (bi // 4)):
            nc = nc_of(nnz_l, gx, gy, my0 * 4)
            zz = decode_cavlc_block(r, nc, 16)
            nnz_l[gy, gx] = int(np.count_nonzero(zz))
            d = _dezigzag(zz) * vy << (qp // 6)
            res = (_itransform4(d) + 32) >> 6
        else:
            nnz_l[gy, gx] = 0
            res = np.zeros((4, 4), np.int64)
        y[py:py + 4, px:px + 4] = np.clip(pred + res, 0, 255)
        done4[gy, gx] = True
    cres = chroma_residuals_p(r, cbp_chroma, mx, my, vc, qpc, nnz_c,
                              nc_of, my0)
    for ci, plane in enumerate(chroma_planes):
        predc = chroma_pred_mb(plane, mx, my, my0, chroma_mode)
        plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(
            predc + cres[ci], 0, 255)
    return qp


def _decode_intra8x8_cavlc(r, mx, my, my0, qp, pps, mbw, y, chroma_planes,
                           nnz_l, nnz_c, nc_of, i4mode, avail4, done4):
    """Full Intra_8x8 macroblock (CAVLC), shared by I slices and
    intra-in-P.  Returns the (possibly delta-updated) slice QP."""
    modes = read_intra8x8_modes_cavlc(r, mx, my, my0, i4mode, avail4)
    chroma_mode = r.ue()
    cbp_code = r.ue()
    if cbp_code >= len(_CBP_INTRA):
        raise UnsupportedStream("bad coded_block_pattern")
    cbp = _CBP_INTRA[cbp_code]
    cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
    if cbp_chroma == 3:
        raise UnsupportedStream("bad chroma cbp")
    if cbp:
        qp = qp + r.se()
    qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
    vc = _vmat(qpc)
    zz64s = []
    for b in range(4):
        has = bool(cbp_luma & (1 << b))
        zz64 = decode_luma8x8_block_cavlc(r, b, mx, my, my0, nnz_l, nc_of, has)
        zz64s.append(zz64 if has else None)
    recon_intra8x8_luma(y, done4, mbw, my0, mx, my, modes, zz64s, qp)
    cres = chroma_residuals_p(r, cbp_chroma, mx, my, vc, qpc, nnz_c,
                              nc_of, my0)
    for ci, plane in enumerate(chroma_planes):
        predc = chroma_pred_mb(plane, mx, my, my0, chroma_mode)
        plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(
            predc + cres[ci], 0, 255)
    return qp


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def _parse_dbf(r: "BitReader", pps) -> Tuple[int, int, int]:
    """Slice-header deblock fields (7.3.3): (idc, offsetA, offsetB).
    idc==1 disables the filter; absent dbf_ctrl means filter on, offsets 0."""
    idc, offa, offb = 0, 0, 0
    if pps["dbf_ctrl"]:
        idc = r.ue()
        if idc > 2:
            raise UnsupportedStream(f"deblock idc {idc}")
        if idc != 1:
            offa = r.se() * 2
            offb = r.se() * 2
    return idc, offa, offb


class IntraDecoder:
    """Decode the own encoder's Annex-B streams -> (Y, Cb, Cr) planes."""

    def decode(self, bs: bytes):
        from ultragrid_tpu_torch.ops.h264_deblock import DeblockCtx, deblock_frame

        sps = pps = None
        state = None
        db = None
        sid = -1
        seen_slice = False
        for nal_type, rbsp in split_nals(bs):
            if nal_type == 7:
                sps = self._parse_sps(rbsp)
            elif nal_type == 8:
                pps = self._parse_pps(rbsp)
            elif nal_type == 5:
                if sps is None or pps is None:
                    raise UnsupportedStream("slice before parameter sets")
                mbw, mbh = sps["mb_w"], sps["mb_h"]
                if state is None:
                    state = (
                        np.zeros((mbh * 16, mbw * 16), np.int64),
                        np.zeros((mbh * 8, mbw * 8), np.int64),
                        np.zeros((mbh * 8, mbw * 8), np.int64),
                    )
                first_mb = BitReader(rbsp).ue()
                if db is None or (first_mb == 0 and seen_slice):
                    # new picture: fresh filter context
                    db = DeblockCtx(mbw, mbh, pps["chroma_off"])
                    sid = -1
                seen_slice = True
                sid += 1
                self._decode_slice(rbsp, sps, pps, state, db=db, slice_id=sid)
        if state is None:
            raise UnsupportedStream("no IDR slice found")
        y, cb, cr = (p.astype(np.uint8) for p in state)
        if db is not None and db.any_enabled:
            deblock_frame(y, cb, cr, db)
        w, h = sps["width"], sps["height"]
        return y[:h, :w], cb[: (h + 1) // 2, : (w + 1) // 2], cr[: (h + 1) // 2, : (w + 1) // 2]

    def _parse_sps(self, rbsp: bytes):
        r = BitReader(rbsp)
        profile = r.u(8)
        r.u(8)  # constraints
        r.u(8)  # level
        if r.ue() != 0:
            raise UnsupportedStream("sps_id != 0")
        if profile not in (66, 77, 88, 100):
            raise UnsupportedStream(f"profile {profile}")
        if profile == 100:
            # High: chroma format + bit depth + scaling matrices (7.3.2.1.1)
            if r.ue() != 1:
                raise UnsupportedStream("chroma_format_idc != 4:2:0")
            if r.ue() != 0 or r.ue() != 0:
                raise UnsupportedStream("bit depth > 8")
            r.u(1)  # qpprime_y_zero_transform_bypass_flag
            if r.u(1):
                raise UnsupportedStream("seq scaling matrices")
        log2_mfn = r.ue() + 4
        poc_type = r.ue()
        log2_poc = 0
        if poc_type == 0:
            log2_poc = r.ue() + 4
        elif poc_type == 1:
            raise UnsupportedStream("poc type 1")
        max_refs = r.ue()  # max_num_ref_frames (sliding-window DPB size)
        r.u(1)
        mb_w = r.ue() + 1
        mb_h = r.ue() + 1
        if r.u(1) != 1:
            raise UnsupportedStream("interlaced")
        direct_8x8 = r.u(1)  # direct_8x8_inference_flag (B direct granularity)
        crop = r.u(1)
        cl = cr_ = ct = cb_ = 0
        if crop:
            cl, cr_, ct, cb_ = r.ue(), r.ue(), r.ue(), r.ue()
        # minimal VUI walk (E.1.1/E.1.2) for bitstream_restriction's
        # max_num_reorder_frames — the display-reorder delay bound for B
        # streams; absent means "decoder picks a safe bound" (max_refs)
        reorder = None

        def skip_hrd(rr):
            cnt = rr.ue() + 1
            rr.u(4), rr.u(4)
            for _ in range(cnt):
                rr.ue(), rr.ue(), rr.u(1)
            rr.u(5), rr.u(5), rr.u(5), rr.u(5)

        if r.u(1):  # vui_parameters_present
            try:
                if r.u(1):  # aspect_ratio_info
                    if r.u(8) == 255:  # Extended_SAR
                        r.u(16), r.u(16)
                if r.u(1):  # overscan_info
                    r.u(1)
                if r.u(1):  # video_signal_type
                    r.u(3), r.u(1)
                    if r.u(1):  # colour_description
                        r.u(8), r.u(8), r.u(8)
                if r.u(1):  # chroma_loc_info
                    r.ue(), r.ue()
                if r.u(1):  # timing_info
                    r.u(32), r.u(32), r.u(1)
                nal_hrd = r.u(1)
                if nal_hrd:
                    skip_hrd(r)
                vcl_hrd = r.u(1)
                if vcl_hrd:
                    skip_hrd(r)
                if nal_hrd or vcl_hrd:
                    r.u(1)  # low_delay_hrd_flag
                r.u(1)  # pic_struct_present
                if r.u(1):  # bitstream_restriction
                    r.u(1)  # motion_vectors_over_pic_boundaries
                    r.ue(), r.ue(), r.ue(), r.ue()
                    reorder = r.ue()  # max_num_reorder_frames
                    r.ue()  # max_dec_frame_buffering
            except Exception:  # noqa: BLE001 — truncated/exotic VUI
                reorder = None
        return {
            "mb_w": mb_w, "mb_h": mb_h, "log2_mfn": log2_mfn,
            "max_refs": max(1, max_refs),
            "poc_type": poc_type, "log2_poc": log2_poc,
            "direct_8x8": direct_8x8,
            "reorder": reorder,
            "width": mb_w * 16 - 2 * (cl + cr_),
            "height": mb_h * 16 - 2 * (ct + cb_),
        }

    def _parse_pps(self, rbsp: bytes):
        r = BitReader(rbsp)
        if r.ue() != 0 or r.ue() != 0:
            raise UnsupportedStream("pps/sps id")
        cabac = r.u(1) == 1
        r.u(1)
        if r.ue() != 0:
            raise UnsupportedStream("slice groups")
        l0_default = r.ue() + 1  # num_ref_idx_l0_default_active_minus1
        l1_default = r.ue() + 1
        weighted_pred = r.u(1)
        weighted_bipred = r.u(2)  # 0 default / 1 explicit / 2 implicit
        init_qp = 26 + r.se()
        r.se()
        chroma_off = r.se()
        dbf_ctrl = r.u(1)
        r.u(1); r.u(1)
        transform_8x8 = False
        if r.more_rbsp_data():
            # High-profile tail (7.3.2.2)
            transform_8x8 = r.u(1) == 1
            if r.u(1):
                raise UnsupportedStream("pic scaling matrices")
            r.se()  # second_chroma_qp_index_offset
        return {"init_qp": init_qp, "chroma_off": chroma_off,
                "dbf_ctrl": dbf_ctrl, "l0_default": l0_default,
                "l1_default": l1_default, "cabac": cabac,
                "weighted_pred": weighted_pred,
                "weighted_bipred": weighted_bipred,
                "transform_8x8": transform_8x8}

    def _decode_slice(self, rbsp: bytes, sps, pps, state, db=None,
                      slice_id: int = 0):
        if pps.get("cabac"):
            raise UnsupportedStream("CABAC slice in CAVLC-only path")
        r = BitReader(rbsp)
        first_mb = r.ue()
        st = r.ue()
        if st % 5 != 2:
            raise UnsupportedStream("not an I slice")
        r.ue()  # pps id
        r.u(sps["log2_mfn"])  # frame_num
        r.ue()  # idr_pic_id
        if sps.get("poc_type", 2) == 0:
            r.u(sps["log2_poc"])  # pic_order_cnt_lsb
        r.u(1); r.u(1)  # dec_ref_pic_marking
        qp = pps["init_qp"] + r.se()
        dbf_idc, dbf_offa, dbf_offb = _parse_dbf(r, pps)
        mbw, mbh = sps["mb_w"], sps["mb_h"]
        y, cbp_, crp = state
        if first_mb % mbw:
            raise UnsupportedStream("slices must start at an MB row")
        my0 = first_mb // mbw  # slice's first MB row: resets availability
        nnz_l = db.nnz if db is not None else np.zeros((mbh * 4, mbw * 4), np.int64)

        def record(my, mx, *, ipcm=False):
            # per-MB deblock inputs (spec 8.7: QPy, intra/IPCM, slice of q0)
            if db is None:
                return
            db.decoded[my, mx] = True
            db.intra[my, mx] = True
            db.ipcm[my, mx] = ipcm
            db.qp[my, mx] = qp
            db.slice_id[my, mx] = slice_id
            db.idc[my, mx] = dbf_idc
            db.offa[my, mx] = dbf_offa
            db.offb[my, mx] = dbf_offb
        nnz_c = [np.zeros((mbh * 2, mbw * 2), np.int64) for _ in range(2)]
        # last meaningful bit = the rbsp stop bit (last set bit of the
        # last nonzero byte); more_rbsp_data() is true before it
        last_nz = len(rbsp) - 1
        while last_nz >= 0 and rbsp[last_nz] == 0:
            last_nz -= 1
        stop_pos = last_nz * 8 + (7 - ((rbsp[last_nz] & -rbsp[last_nz]).bit_length() - 1))
        def nc_of(nn, gx, gy, gy_min):
            na = nn[gy, gx - 1] if gx > 0 else None
            nb = nn[gy - 1, gx] if gy > gy_min else None
            if na is not None and nb is not None:
                return (int(na) + int(nb) + 1) >> 1
            if na is not None:
                return int(na)
            if nb is not None:
                return int(nb)
            return 0

        # intra4x4 prediction-mode grid: 2 (DC) for non-I4x4 MBs per spec
        # 8.3.1.1; -1 marks not-yet-decoded (treated as unavailable -> DC)
        i4mode = np.full((mbh * 4, mbw * 4), 2, np.int64)
        # which 4x4 luma blocks are reconstructed (drives top-right
        # availability for prediction, spec 6.4.12 neighbour rules)
        done4 = np.zeros((mbh * 4, mbw * 4), bool)
        # which blocks have been PARSED (mode-prediction availability is
        # address-based: all 16 modes parse before any reconstruction)
        avail4 = np.zeros((mbh * 4, mbw * 4), bool)

        def luma_neighbors(px, py, need_tr):
            """(t[0..7], l[0..3], tl) sample arrays for block at pixel
            (px, py); None where unavailable."""
            gx, gy = px // 4, py // 4
            top = None
            if py > my0 * 16 and done4[gy - 1, gx]:
                t8 = np.empty(8, np.int64)
                t8[:4] = y[py - 1, px : px + 4]
                if need_tr and gx + 1 < mbw * 4 and done4[gy - 1, gx + 1]:
                    t8[4:] = y[py - 1, px + 4 : px + 8]
                else:
                    t8[4:] = y[py - 1, px + 3]
                top = t8
            left = None
            if px > 0 and done4[gy, gx - 1]:
                left = y[py : py + 4, px - 1].astype(np.int64)
            tl = None
            if top is not None and left is not None and px > 0 and py > my0 * 16:
                tl = int(y[py - 1, px - 1])
            return top, left, tl

        def chroma_pred_block(plane, mx, my, mode):
            x0, y0 = mx * 8, my * 8
            lcol = plane[y0 : y0 + 8, x0 - 1].astype(np.int64) if mx > 0 else None
            trow = plane[y0 - 1, x0 : x0 + 8].astype(np.int64) if my > my0 else None
            if mode == 0:  # DC per 4x4 sub-block (spec 8.3.4.1)
                preds = np.zeros((8, 8), np.int64)
                for by in range(2):
                    for bx in range(2):
                        lc = lcol[by * 4 : by * 4 + 4] if lcol is not None else None
                        tr = trow[bx * 4 : bx * 4 + 4] if trow is not None else None
                        use_l, use_t = lc is not None, tr is not None
                        if bx == 1 and by == 0 and tr is not None:
                            use_l = False
                        if bx == 0 and by == 1 and lc is not None:
                            use_t = False
                        if use_l and use_t:
                            v = (int(lc.sum()) + int(tr.sum()) + 4) >> 3
                        elif use_l:
                            v = (int(lc.sum()) + 2) >> 2
                        elif use_t:
                            v = (int(tr.sum()) + 2) >> 2
                        else:
                            v = 128
                        preds[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = v
                return preds
            if mode == 1:  # Horizontal
                return np.repeat(lcol[:, None], 8, axis=1)
            if mode == 2:  # Vertical
                return np.repeat(trow[None, :], 8, axis=0)
            if mode == 3:  # Plane
                tl = int(plane[y0 - 1, x0 - 1])
                return _pred8_chroma_plane(trow, lcol, tl)
            raise UnsupportedStream(f"chroma pred mode {mode}")

        def residual4(r_, nn, gx, gy, gy_min, v, qp_, has):
            """Read (if has) one 16-coeff CAVLC block and return the spatial
            residual (already includes DC); updates nnz."""
            if not has:
                nn[gy, gx] = 0
                return np.zeros((4, 4), np.int64)
            nc = nc_of(nn, gx, gy, gy_min)
            zz = decode_cavlc_block(r_, nc, 16)
            nn[gy, gx] = int(np.count_nonzero(zz))
            d = _dezigzag(zz) * v << (qp_ // 6)
            return (_itransform4(d) + 32) >> 6

        def chroma_residuals(r_, cbp_chroma, mx, my, vc, qpc):
            cdc = [np.zeros(4, np.int64), np.zeros(4, np.int64)]
            cac = [np.zeros((2, 2, 16), np.int64) for _ in range(2)]
            if cbp_chroma:
                for ci in range(2):
                    cdc[ci] = decode_cavlc_block(r_, -1, 4)
            if cbp_chroma == 2:
                for ci in range(2):
                    for bx, by in ((0, 0), (1, 0), (0, 1), (1, 1)):
                        gx, gy = mx * 2 + bx, my * 2 + by
                        nc = nc_of(nnz_c[ci], gx, gy, my0 * 2)
                        zz = decode_cavlc_block(r_, nc, 15)
                        cac[ci][by, bx, 1:] = zz
                        nnz_c[ci][gy, gx] = int(np.count_nonzero(zz))
            else:
                for ci in range(2):
                    nnz_c[ci][my * 2 : my * 2 + 2, mx * 2 : mx * 2 + 2] = 0
            res = [np.zeros((8, 8), np.int64) for _ in range(2)]
            for ci in range(2):
                fdc = H._H2 @ np.array([[cdc[ci][0], cdc[ci][1]],
                                        [cdc[ci][2], cdc[ci][3]]], np.int64) @ H._H2
                v00c = int(vc[0, 0])
                dcsc = ((fdc * v00c) << (qpc // 6)) >> 1
                for by in range(2):
                    for bx in range(2):
                        d = _dezigzag(cac[ci][by, bx]) * vc << (qpc // 6)
                        d[0, 0] = dcsc[by, bx]
                        res[ci][by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = (
                            (_itransform4(d) + 32) >> 6
                        )
            return res

        mb_addr = first_mb
        while r.pos < stop_pos:
            my, mx = mb_addr // mbw, mb_addr % mbw
            mb_addr += 1
            qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
            vy = _vmat(qp)
            vc = _vmat(qpc)
            mb_type = r.ue()
            if mb_type == 25:  # I_PCM
                r.byte_align()
                for i in range(16):
                    for j in range(16):
                        y[my * 16 + i, mx * 16 + j] = r.u(8)
                for plane in (cbp_, crp):
                    for i in range(8):
                        for j in range(8):
                            plane[my * 8 + i, mx * 8 + j] = r.u(8)
                nnz_l[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 16
                for nn in nnz_c:
                    nn[my * 2 : my * 2 + 2, mx * 2 : mx * 2 + 2] = 16
                done4[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = True
                avail4[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = True
                i4mode[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 2
                record(my, mx, ipcm=True)
                continue

            if mb_type == 0 and pps.get("transform_8x8") and r.u(1):
                # I_NxN with transform_size_8x8_flag == 1 (Intra_8x8)
                qp = _decode_intra8x8_cavlc(
                    r, mx, my, my0, qp, pps, mbw, y, (cbp_, crp), nnz_l,
                    nnz_c, nc_of, i4mode, avail4, done4)
                qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
                record(my, mx)
                if db is not None:
                    db.t8x8[my, mx] = True
                continue

            if mb_type == 0:  # I_4x4 (I_NxN with the 4x4 transform)
                # prediction modes for all 16 blocks (spec 8.3.1.1)
                modes = np.zeros(16, np.int64)
                for bi, (bx, by) in enumerate(H._BLK_ORDER):
                    gx, gy = mx * 4 + bx, my * 4 + by
                    ma = i4mode[gy, gx - 1] if gx > 0 and avail4[gy, gx - 1] else -1
                    mb_ = i4mode[gy - 1, gx] if gy > my0 * 4 and avail4[gy - 1, gx] else -1
                    # unavailable neighbour -> 2 (non-I4x4 MBs already
                    # recorded as 2 in the grid)
                    pm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
                    if ma < 0 or mb_ < 0:
                        pm = 2
                    if r.u(1):  # prev_intra4x4_pred_mode_flag
                        modes[bi] = pm
                    else:
                        rem = r.u(3)
                        modes[bi] = rem if rem < pm else rem + 1
                    # record at parse time so in-MB neighbours see it;
                    # done4 separately gates SAMPLE availability
                    i4mode[gy, gx] = modes[bi]
                    avail4[gy, gx] = True
                chroma_mode = r.ue()
                cbp = r.ue()
                if cbp >= len(_CBP_INTRA):
                    raise UnsupportedStream("bad coded_block_pattern")
                cbp = _CBP_INTRA[cbp]
                cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
                if cbp_chroma == 3:
                    raise UnsupportedStream("bad chroma cbp")
                if cbp:
                    qp = qp + r.se()
                    qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
                    vy, vc = _vmat(qp), _vmat(qpc)
                # per-block: residual read order is H._BLK_ORDER; predict +
                # reconstruct in the same order so neighbours are ready
                for bi, (bx, by) in enumerate(H._BLK_ORDER):
                    gx, gy = mx * 4 + bx, my * 4 + by
                    px, py = gx * 4, gy * 4
                    mode = int(modes[bi])
                    need_tr = mode in (3, 7)
                    top, left, tl = luma_neighbors(px, py, need_tr)
                    pred = _pred4x4(mode, top, left, tl)
                    if getattr(self, "trace", None) is not None:
                        self.trace.append((px, py, mode))
                    has = bool(cbp_luma & (1 << (bi // 4)))
                    res = residual4(r, nnz_l, gx, gy, my0 * 4, vy, qp, has)
                    y[py : py + 4, px : px + 4] = np.clip(pred + res, 0, 255)
                    done4[gy, gx] = True
                cres = chroma_residuals(r, cbp_chroma, mx, my, vc, qpc)
                for ci, plane in enumerate((cbp_, crp)):
                    predc = chroma_pred_block(plane, mx, my, chroma_mode)
                    plane[my * 8 : my * 8 + 8, mx * 8 : mx * 8 + 8] = np.clip(
                        predc + cres[ci], 0, 255
                    )
                record(my, mx)
                continue

            if not 1 <= mb_type <= 24:
                raise UnsupportedStream(f"mb_type {mb_type}")
            t = mb_type - 1
            pred_mode = t % 4
            cbp_chroma = (t // 4) % 3
            cbp_luma = 15 if t >= 12 else 0
            chroma_mode = r.ue()
            delta = r.se()  # mb_qp_delta (always present for I_16x16)
            qp = qp + delta
            qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
            vy, vc = _vmat(qp), _vmat(qpc)
            i4mode[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 2
            avail4[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = True

            # luma DC coefficients
            nc = nc_of(nnz_l, mx * 4, my * 4, my0 * 4)
            dc_zz = decode_cavlc_block(r, nc, 16)
            ac = np.zeros((4, 4, 16), np.int64)
            if cbp_luma:
                for bx, by in H._BLK_ORDER:
                    gx, gy = mx * 4 + bx, my * 4 + by
                    nc = nc_of(nnz_l, gx, gy, my0 * 4)
                    zz = decode_cavlc_block(r, nc, 15)
                    ac[by, bx, 1:] = zz
                    nnz_l[gy, gx] = int(np.count_nonzero(zz))
            else:
                nnz_l[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = 0
            cres_pending = (r, cbp_chroma, mx, my, vc, qpc)

            # ---- predict luma (spec 8.3.3: V/H/DC/Plane) ----
            left = y[my * 16 : my * 16 + 16, mx * 16 - 1] if mx > 0 else None
            top = y[my * 16 - 1, mx * 16 : mx * 16 + 16] if my > my0 else None
            if pred_mode == 0:
                pred16 = np.repeat(top[None, :].astype(np.int64), 16, axis=0)
            elif pred_mode == 1:
                pred16 = np.repeat(left[:, None].astype(np.int64), 16, axis=1)
            elif pred_mode == 2:
                if left is not None and top is not None:
                    dcv = (int(left.sum()) + int(top.sum()) + 16) >> 5
                elif left is not None:
                    dcv = (int(left.sum()) + 8) >> 4
                elif top is not None:
                    dcv = (int(top.sum()) + 8) >> 4
                else:
                    dcv = 128
                pred16 = np.full((16, 16), dcv, np.int64)
            else:
                tl = int(y[my * 16 - 1, mx * 16 - 1])
                pred16 = _pred16_plane(top.astype(np.int64), left.astype(np.int64), tl)
            # DC: inverse hadamard then scale (spec 8.5.10)
            f = _ihadamard4(_dezigzag(dc_zz))
            v00 = int(vy[0, 0])
            if qp >= 12:
                dcs = (f * v00) << (qp // 6 - 2)
            else:
                dcs = (f * v00 + (1 << (1 - qp // 6))) >> (2 - qp // 6)
            for by in range(4):
                for bx in range(4):
                    d = _dezigzag(ac[by, bx]) * vy << (qp // 6)
                    d[0, 0] = dcs[by, bx]
                    res = (_itransform4(d) + 32) >> 6
                    blk = np.clip(pred16[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] + res,
                                  0, 255)
                    y[my * 16 + by * 4 : my * 16 + by * 4 + 4,
                      mx * 16 + bx * 4 : mx * 16 + bx * 4 + 4] = blk
            done4[my * 4 : my * 4 + 4, mx * 4 : mx * 4 + 4] = True

            # ---- chroma ----
            cres = chroma_residuals(*cres_pending)
            for ci, plane in enumerate((cbp_, crp)):
                predc = chroma_pred_block(plane, mx, my, chroma_mode)
                plane[my * 8 : my * 8 + 8, mx * 8 : mx * 8 + 8] = np.clip(
                    predc + cres[ci], 0, 255
                )
            record(my, mx)
        return y.astype(np.uint8), cbp_.astype(np.uint8), crp.astype(np.uint8)


# ---------------------------------------------------------------------------
# Inter (P-slice) support — own-encoder streams: P_Skip + P_L0_16x16 with
# integer-pel luma motion + I_16x16 fallback macroblocks.
# (ref role: the decode half of src/video_compress/libavcodec.cpp's
# inter-frame world, built from scratch like the intra decoder above.)
# ---------------------------------------------------------------------------

# coded_block_pattern me(v) mapping, codeNum -> cbp, Inter column of spec
# Table 9-4 (standard constants; validated against libavcodec in tests)
_CBP_INTER = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
]
_CBP_INTER_FWD = {cbp: i for i, cbp in enumerate(_CBP_INTER)}

MC_PAD = 32  # edge padding around reference planes (covers the MV range)


def pad_ref(plane: np.ndarray) -> np.ndarray:
    return np.pad(np.asarray(plane), MC_PAD, mode="edge")


def half_planes(refp: np.ndarray):
    """Spec 8.4.2.2.1 half-sample luma planes over a padded reference:
    b (half-x), h (half-y), j (half-x + half-y).  b/h from the 6-tap
    (1,-5,20,20,-5,1) filter; j from the INTERMEDIATE b1 values filtered
    vertically (the spec's two-stage path, kept exactly)."""
    r = refp.astype(np.int64)

    def tap6(a, axis):
        def sh(k):
            return a[2 + k:a.shape[0] - 3 + k] if axis == 0 else \
                a[:, 2 + k:a.shape[1] - 3 + k]
        return (sh(-2) - 5 * sh(-1) + 20 * sh(0) + 20 * sh(1)
                - 5 * sh(2) + sh(3))

    # b1[y, x] = 6-tap across x at (x + 0.5); defined for x in [2, W-4]
    b1 = tap6(r, axis=1)
    h1 = tap6(r, axis=0)
    b = np.clip((b1 + 16) >> 5, 0, 255)
    h = np.clip((h1 + 16) >> 5, 0, 255)
    # j: vertical 6-tap over b1 (intermediate, unclipped)
    j1 = (b1[:-5] - 5 * b1[1:-4] + 20 * b1[2:-3] + 20 * b1[3:-2]
          - 5 * b1[4:-1] + b1[5:])
    j = np.clip((j1 + 512) >> 10, 0, 255)
    # align all planes so plane[y, x] is the half-sample at/after (y, x)
    # with the same origin as refp[2:, 2:]-style cropping:
    # b[y, x] covers (y, x + 0.5) for refp coords y in [0..], x in [2..]
    return b, h, j


# quarter-sample positions (spec 8.4.2.2.1 figure): each quarter position
# averages (with upward rounding) its two nearest full/half samples.  The
# table maps (fx, fy) -> two constituents as (cfx, cfy, dy, dx) where
# (cfx, cfy) in {0, 2} selects the G/b/h/j plane and (dy, dx) is an extra
# integer-sample offset (m = h one column right, s = b one row down).
_QTAB = {
    (1, 0): ((0, 0, 0, 0), (2, 0, 0, 0)),  # a = (G + b) >> 1
    (3, 0): ((2, 0, 0, 0), (0, 0, 0, 1)),  # c = (b + G>) >> 1
    (0, 1): ((0, 0, 0, 0), (0, 2, 0, 0)),  # d = (G + h) >> 1
    (0, 3): ((0, 2, 0, 0), (0, 0, 1, 0)),  # n = (h + Gv) >> 1
    (1, 1): ((2, 0, 0, 0), (0, 2, 0, 0)),  # e = (b + h) >> 1
    (3, 1): ((2, 0, 0, 0), (0, 2, 0, 1)),  # g = (b + m) >> 1
    (1, 3): ((0, 2, 0, 0), (2, 0, 1, 0)),  # p = (h + s) >> 1
    (3, 3): ((2, 0, 1, 0), (0, 2, 0, 1)),  # r = (s + m) >> 1
    (2, 1): ((2, 0, 0, 0), (2, 2, 0, 0)),  # f = (b + j) >> 1
    (2, 3): ((2, 2, 0, 0), (2, 0, 1, 0)),  # q = (j + s) >> 1
    (1, 2): ((0, 2, 0, 0), (2, 2, 0, 0)),  # i = (h + j) >> 1
    (3, 2): ((2, 2, 0, 0), (0, 2, 0, 1)),  # k = (j + m) >> 1
}


def mc_luma(refp: np.ndarray, px: int, py: int, mvx: int, mvy: int,
            w: int = 16, h: int = 16, halfp=None) -> np.ndarray:
    """Luma motion compensation at full QUARTER-sample resolution (mv in
    quarter units, spec 8.4.2.2.1: 6-tap half samples + rounded averages
    for the 12 quarter positions)."""
    fx, fy = mvx & 3, mvy & 3
    x0 = px + (mvx >> 2) + MC_PAD
    y0 = py + (mvy >> 2) + MC_PAD
    if not fx and not fy:
        return refp[y0:y0 + h, x0:x0 + w].astype(np.int64)
    if halfp is None:
        halfp = half_planes(refp)
    b, hp, j = halfp

    def samp(cfx, cfy, dy, dx):
        yy, xx = y0 + dy, x0 + dx
        if cfx == 0 and cfy == 0:
            return refp[yy:yy + h, xx:xx + w].astype(np.int64)
        if cfx == 2 and cfy == 0:
            return b[yy:yy + h, xx - 2:xx - 2 + w].astype(np.int64)
        if cfx == 0 and cfy == 2:
            return hp[yy - 2:yy - 2 + h, xx:xx + w].astype(np.int64)
        return j[yy - 2:yy - 2 + h, xx - 2:xx - 2 + w].astype(np.int64)

    if fx & 1 or fy & 1:  # quarter position: rounded average of two
        ca, cb_ = _QTAB[(fx, fy)]
        return (samp(*ca) + samp(*cb_) + 1) >> 1
    return samp(fx, fy, 0, 0)


def mc_chroma(refp: np.ndarray, px: int, py: int, mvx: int, mvy: int,
              w: int = 8, h: int = 8) -> np.ndarray:
    """Chroma MC per spec 8.4.2.2.2: eighth-sample bilinear (a quarter-luma
    mv is numerically an eighth-chroma mv in 4:2:0)."""
    xi, xf = (mvx >> 3), mvx & 7
    yi, yf = (mvy >> 3), mvy & 7
    x0 = px + xi + MC_PAD
    y0 = py + yi + MC_PAD
    a = refp[y0:y0 + h, x0:x0 + w].astype(np.int64)
    if not xf and not yf:
        return a
    b = refp[y0:y0 + h, x0 + 1:x0 + w + 1].astype(np.int64)
    c = refp[y0 + 1:y0 + h + 1, x0:x0 + w].astype(np.int64)
    d = refp[y0 + 1:y0 + h + 1, x0 + 1:x0 + w + 1].astype(np.int64)
    return ((8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
            + (8 - xf) * yf * c + xf * yf * d + 32) >> 6


def _mv_neighbors(mx: int, my: int, mbw: int, my0: int):
    """(A, B, C-with-D-fallback) MB coordinates; None = unavailable
    (spec 8.4.1.3 / 6.4.11 with 16x16 partitions only)."""
    a = (mx - 1, my) if mx > 0 else None
    b = (mx, my - 1) if my > my0 else None
    c = (mx + 1, my - 1) if my > my0 and mx + 1 < mbw else None
    if c is None:
        c = (mx - 1, my - 1) if my > my0 and mx > 0 else None
    return a, b, c


def mv_pred(mvs: np.ndarray, refs: np.ndarray, mx: int, my: int,
            mbw: int, my0: int, refidx: int = 0) -> Tuple[int, int]:
    """Median MV predictor for P_L0_16x16 (spec 8.4.1.3; JM order: the
    geometric left-rule first, then the single-matching-ref rule)."""
    a, b, c = _mv_neighbors(mx, my, mbw, my0)

    def val(n):
        if n is None:
            return 0, 0, -1
        x, y = n
        return int(mvs[y, x, 0]), int(mvs[y, x, 1]), int(refs[y, x])

    va, vb, vc = val(a), val(b), val(c)
    if b is None and c is None and a is not None:
        return va[0], va[1]
    matches = [v for v in (va, vb, vc) if v[2] == refidx]
    if len(matches) == 1:
        return matches[0][0], matches[0][1]
    xs = sorted((va[0], vb[0], vc[0]))
    ys = sorted((va[1], vb[1], vc[1]))
    return xs[1], ys[1]


def skip_mv(mvs: np.ndarray, refs: np.ndarray, mx: int, my: int,
            mbw: int, my0: int) -> Tuple[int, int]:
    """P_Skip motion vector (spec 8.4.1.1)."""
    a, b, _ = _mv_neighbors(mx, my, mbw, my0)
    if a is None or b is None:
        return 0, 0
    for n in (a, b):
        x, y = n
        if refs[y, x] == 0 and mvs[y, x, 0] == 0 and mvs[y, x, 1] == 0:
            return 0, 0
    return mv_pred(mvs, refs, mx, my, mbw, my0)


def _fetch4(mv4, ref4, dec4, gy, gx, my0, mbw):
    """Neighbour (mvx, mvy, ref) at 4x4-grid position, None if unavailable
    (outside frame/slice or not yet decoded — spec 6.4.11 availability)."""
    if gx < 0 or gy < my0 * 4 or gx >= mbw * 4 or not dec4[gy, gx]:
        return None
    return int(mv4[gy, gx, 0]), int(mv4[gy, gx, 1]), int(ref4[gy, gx])


def mv_pred4(mv4, ref4, dec4, gy, gx, pw, refidx, my0, mbw,
             shape: Optional[str] = None):
    """Median MV prediction at partition granularity (spec 8.4.1.3 with
    6.4.11 neighbours on the 4x4 grid).  ``shape`` enables the directional
    16x8/8x16 rules ('16x8_0', '16x8_1', '8x16_0', '8x16_1')."""
    a = _fetch4(mv4, ref4, dec4, gy, gx - 1, my0, mbw)
    b = _fetch4(mv4, ref4, dec4, gy - 1, gx, my0, mbw)
    c = _fetch4(mv4, ref4, dec4, gy - 1, gx + pw, my0, mbw)
    if c is None:  # D fallback (8.4.1.3.2)
        c = _fetch4(mv4, ref4, dec4, gy - 1, gx - 1, my0, mbw)
    # directional rules for the two-partition shapes (8.4.1.3 items 2-5)
    if shape == "16x8_0" and b is not None and b[2] == refidx:
        return b[0], b[1]
    if shape == "16x8_1" and a is not None and a[2] == refidx:
        return a[0], a[1]
    if shape == "8x16_0" and a is not None and a[2] == refidx:
        return a[0], a[1]
    if shape == "8x16_1" and c is not None and c[2] == refidx:
        return c[0], c[1]

    def val(n):
        return (0, 0, -1) if n is None else n

    va, vb, vc = val(a), val(b), val(c)
    if b is None and c is None and a is not None:
        return va[0], va[1]
    matches = [v for v in (va, vb, vc) if v[2] == refidx]
    if len(matches) == 1:
        return matches[0][0], matches[0][1]
    xs = sorted((va[0], vb[0], vc[0]))
    ys = sorted((va[1], vb[1], vc[1]))
    return xs[1], ys[1]


def skip_mv4(mv4, ref4, dec4, mx, my, my0, mbw):
    """P_Skip motion vector (spec 8.4.1.1) on the 4x4 grid."""
    a = _fetch4(mv4, ref4, dec4, my * 4, mx * 4 - 1, my0, mbw)
    b = _fetch4(mv4, ref4, dec4, my * 4 - 1, mx * 4, my0, mbw)
    if a is None or b is None:
        return 0, 0
    for n in (a, b):
        if n[2] == 0 and n[0] == 0 and n[1] == 0:
            return 0, 0
    return mv_pred4(mv4, ref4, dec4, my * 4, mx * 4, 4, 0, my0, mbw)


# P sub-macroblock geometry: sub_mb_type -> list of (dy, dx, pw, ph) in
# 4x4 units within the 8x8 (spec Table 7-17, raster sub-partition order)
# B two-partition mb_types 4..21 (Table 7-14): (mode of part0, part1)
# per PAIR index (mb_type-4)//2; 0 = Pred_L0, 1 = Pred_L1, 2 = BiPred.
_B_PAIR = [
    (0, 0), (1, 1), (0, 1), (1, 0), (0, 2), (1, 2), (2, 0), (2, 1), (2, 2),
]
# B sub_mb_type (Table 7-18): value -> (_SUB_PARTS shape key, mode);
# 0 = B_Direct_8x8 handled separately.
_B_SUB = {
    1: (0, 0), 2: (0, 1), 3: (0, 2),     # 8x8 L0 / L1 / Bi
    4: (1, 0), 5: (2, 0),                # 8x4 / 4x8 L0
    6: (1, 1), 7: (2, 1),                # 8x4 / 4x8 L1
    8: (1, 2), 9: (2, 2),                # 8x4 / 4x8 Bi
    10: (3, 0), 11: (3, 1), 12: (3, 2),  # 4x4 L0 / L1 / Bi
}

_SUB_PARTS = {
    0: [(0, 0, 2, 2)],                                        # P_L0_8x8
    1: [(0, 0, 2, 1), (1, 0, 2, 1)],                          # P_L0_8x4
    2: [(0, 0, 1, 2), (0, 1, 1, 2)],                          # P_L0_4x8
    3: [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)],  # P_L0_4x4
}


def _parse_ref_mod_l0(r, nrefs: int, metas, cur_fn: int, max_fn: int,
                      l0_active: int, init=None):
    """ref_pic_list_modification for one list (7.3.3.1 + 8.2.4.3.1) ->
    list of DPB indices of length ``l0_active``.  ``init`` overrides the
    initial list order (B lists are POC-sorted, 8.2.4.2.3); default is
    DPB order (descending PicNum, the P initialization).  The
    insert-and-compact process legitimately produces DUPLICATE entries
    (two commands naming the same PicNum) — that is how x264's smart
    weighted-P (``weightp=2``) binds two different weight sets to one
    reference picture."""
    if init is None:
        init = list(range(nrefs))
    if not r.u(1):  # ref_pic_list_modification_flag_lX
        if l0_active > len(init):
            raise UnsupportedStream(
                f"{l0_active} active refs > {len(init)} decoded")
        return init[:l0_active]

    def picnum(i):
        fn = metas[i]["fn"]
        return fn - max_fn if fn > cur_fn else fn

    lst = list(init)
    pred = cur_fn
    refidx = 0
    while True:
        idc = r.ue()
        if idc == 3:
            break
        if idc not in (0, 1):
            raise UnsupportedStream("long-term ref modification")
        ad = r.ue() + 1
        nowrap = pred - ad if idc == 0 else pred + ad
        if nowrap < 0:
            nowrap += max_fn
        elif nowrap >= max_fn:
            nowrap -= max_fn
        pred = nowrap
        pn = nowrap - (max_fn if nowrap > cur_fn else 0)
        tgt = next((i for i in range(nrefs) if picnum(i) == pn), None)
        if tgt is None:
            raise UnsupportedStream("ref modification PicNum not in DPB")
        # 8.2.4.3.1: shift right, insert at refidx, drop LATER entries
        # with the same PicNum (earlier duplicates survive)
        lst = (lst[:refidx] + [tgt]
               + [x for x in lst[refidx:] if picnum(x) != pn])
        refidx += 1
    if l0_active > len(lst):
        raise UnsupportedStream("modified ref list shorter than active")
    return lst[:l0_active]


def _parse_weight_entries(r, n: int, ld: int, cd: int):
    luma, chroma = [], []
    for _ in range(n):
        if r.u(1):
            luma.append((r.se(), r.se()))
        else:
            luma.append((1 << ld, 0))
        if r.u(1):
            chroma.append(((r.se(), r.se()), (r.se(), r.se())))
        else:
            chroma.append(((1 << cd, 0), (1 << cd, 0)))
    return luma, chroma


def _parse_pred_weights_l0(r, l0_active: int, l1_active: int = 0):
    """pred_weight_table, 4:2:0 (7.3.3.2).  Absent flags yield the
    identity weight (1 << denom, 0).  For B slices pass ``l1_active`` to
    also read the L1 entries; returns (wp0, wp1-or-None)."""
    ld = r.ue()
    cd = r.ue()
    if ld > 7 or cd > 7:
        raise UnsupportedStream("weight denom > 7")
    luma, chroma = _parse_weight_entries(r, l0_active, ld, cd)
    wp0 = {"ld": ld, "cd": cd, "luma": luma, "chroma": chroma}
    if not l1_active:
        return wp0
    luma1, chroma1 = _parse_weight_entries(r, l1_active, ld, cd)
    wp1 = {"ld": ld, "cd": cd, "luma": luma1, "chroma": chroma1}
    return wp0, wp1


def _weight_pred(block: np.ndarray, w: int, o: int, logd: int) -> np.ndarray:
    """Explicit weighted sample prediction, one list (8.4.2.3.2)."""
    if logd:
        p = (block * w + (1 << (logd - 1))) >> logd
    else:
        p = block * w
    return np.clip(p + o, 0, 255)


class StreamDecoder:
    """Stateful Annex-B decoder for own-encoder streams: IDR / I pictures
    (via IntraDecoder's slice machinery) + P pictures (P_Skip, P_L0_16x16
    integer-MV, I_16x16-in-P).  ``decode_au`` returns one (Y, Cb, Cr)
    tuple per access unit; ``decode_stream`` splits a whole elementary
    stream on first_mb_in_slice == 0 boundaries."""

    def __init__(self):
        self.sps = None
        self.pps = None
        self._intra = IntraDecoder()
        # sliding-window DPB, most recent first (default P ref list order =
        # descending PicNum, spec 8.2.4.2.1); entries are (y, cb, cr) uint8
        self.dpb: list = []
        # per-entry (frame_num, picture id): frame_num drives ref-list
        # modification PicNum math; the unique picture id feeds the deblock
        # bS "same reference picture" test (refidx is NOT picture identity
        # once the list holds duplicates)
        self.dpb_meta: list = []
        self._pic_seq = 0
        self._cur_frame_num = 0
        self._cur_poc_lsb = 0
        self._dpb_pad: list = []  # lazy [padded_planes, half_planes] per ref
        # POC type 0 tracking (8.2.1.1) + display reorder (B streams)
        self._poc_msb = 0
        self._poc_lsb_prev = 0
        self._poc_base = 0      # global display key across IDR resets
        self._gop_max_poc = 0
        self._outq: list = []   # (display_key, seq, frame) pending output
        self._outseq = 0
        # per-picture L0/L1 refidx grids (picture-wide: colocated motion
        # for B spatial direct reads them after the picture completes)
        self._pic_ref0 = None
        self._pic_ref1 = None
        self._pending_mmco = None

    @property
    def ref(self):
        return self.dpb[0] if self.dpb else None

    # -- bitstream walking -------------------------------------------------

    def decode_stream(self, bs: bytes):
        frames = []
        au: list = []
        for nal_type, ref_idc, rbsp in split_nals_ref(bs):
            if nal_type in (1, 5):
                first_mb = BitReader(rbsp).ue()
                if first_mb == 0 and any(t in (1, 5) for t, _, _ in au):
                    got = self._decode_units(au)
                    if got is not None:
                        frames.append(got)
                    au = []
            au.append((nal_type, ref_idc, rbsp))
        if any(t in (1, 5) for t, _, _ in au):
            got = self._decode_units(au)
            if got is not None:
                frames.append(got)
        frames.extend(self.flush())
        return frames

    def decode_au(self, bs: bytes):
        """Decode one access unit.  Returns the next frame in DISPLAY
        order, or None while the reorder buffer of a B stream is still
        priming (no-reorder streams always return a frame)."""
        return self._decode_units(list(split_nals_ref(bs)))

    def flush(self):
        """Drain the display-reorder queue (end of stream)."""
        self._outq.sort(key=lambda t: (t[0], t[1]))
        out = [f for _, _, f in self._outq]
        self._outq = []
        return out

    def _reorder_delay(self) -> int:
        if self.sps.get("poc_type", 2) != 0:
            return 0  # POC type 2: display order == decode order
        r = self.sps.get("reorder")
        return r if r is not None else self.sps.get("max_refs", 1)

    def _poc_preview(self, fnum: int) -> int:
        """Current picture's POC without committing msb/lsb state (the
        slice header needs it for B list initialization)."""
        if self.sps.get("poc_type", 2) != 0:
            return self._pic_seq * 2
        lsb = self._cur_poc_lsb
        max_lsb = 1 << self.sps["log2_poc"]
        prev_msb, prev_lsb = self._poc_msb, self._poc_lsb_prev
        if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
            msb = prev_msb + max_lsb
        elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
            msb = prev_msb - max_lsb
        else:
            msb = prev_msb
        return msb + lsb

    def _compute_poc(self, kind: str, is_ref: bool) -> int:
        """Picture order count, POC type 0 (8.2.1.1) / type 2."""
        if self.sps.get("poc_type", 2) != 0:
            return self._pic_seq * 2
        lsb = self._cur_poc_lsb
        max_lsb = 1 << self.sps["log2_poc"]
        if kind == "I":
            self._poc_msb = 0
            self._poc_lsb_prev = 0
            msb = 0
        else:
            prev_msb, prev_lsb = self._poc_msb, self._poc_lsb_prev
            if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                msb = prev_msb + max_lsb
            elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                msb = prev_msb - max_lsb
            else:
                msb = prev_msb
        if is_ref:
            self._poc_msb = msb
            self._poc_lsb_prev = lsb
        return msb + lsb

    def _decode_units(self, units):
        from ultragrid_tpu_torch.ops.h264_deblock import DeblockCtx, deblock_frame

        state = None
        kind = None
        db = None
        sid = -1
        ref_idc_pic = 1
        for unit in units:
            if len(unit) == 3:
                nal_type, ref_idc, rbsp = unit
            else:  # legacy 2-tuple callers
                nal_type, rbsp = unit
                ref_idc = 1
            if nal_type == 7:
                self.sps = self._intra._parse_sps(rbsp)
            elif nal_type == 8:
                self.pps = self._intra._parse_pps(rbsp)
            elif nal_type in (1, 5):
                if self.sps is None or self.pps is None:
                    raise UnsupportedStream("slice before parameter sets")
                mbw, mbh = self.sps["mb_w"], self.sps["mb_h"]
                ref_idc_pic = ref_idc
                if state is None:
                    state = (
                        np.zeros((mbh * 16, mbw * 16), np.int64),
                        np.zeros((mbh * 8, mbw * 8), np.int64),
                        np.zeros((mbh * 8, mbw * 8), np.int64),
                    )
                    self._pic_ref0 = np.full((mbh * 4, mbw * 4), -1, np.int64)
                    self._pic_ref1 = np.full((mbh * 4, mbw * 4), -1, np.int64)
                if db is None:
                    db = DeblockCtx(mbw, mbh, self.pps["chroma_off"])
                sid += 1
                if self.pps.get("cabac"):
                    from ultragrid_tpu_torch.ops.h264_cabac import (
                        CabacPictureCtx, decode_slice_cabac)

                    if getattr(self, "_cabac_pic", None) is None:
                        self._cabac_pic = CabacPictureCtx(mbw, mbh)
                    st = BitReader(rbsp)
                    st.ue()
                    slice_type = st.ue() % 5
                    kind = {2: "I", 0: "P", 1: "B"}.get(slice_type)
                    if kind is None:
                        raise UnsupportedStream(
                            f"CABAC slice type {slice_type}")
                    if kind != "I" and not self.dpb:
                        raise UnsupportedStream(
                            f"{kind} slice without a reference")
                    decode_slice_cabac(self, rbsp, nal_type, state, db, sid,
                                       self._cabac_pic, ref_idc=ref_idc)
                    continue
                st = BitReader(rbsp)
                st.ue()  # first_mb
                slice_type = st.ue()
                if slice_type % 5 == 2:  # I slice
                    if nal_type != 5:
                        # the intra slice parser assumes the IDR header shape
                        raise UnsupportedStream("non-IDR I slice")
                    kind = "I"
                    self._intra._decode_slice(rbsp, self.sps, self.pps, state,
                                              db=db, slice_id=sid)
                elif slice_type % 5 in (0, 1):  # P / B slice
                    if not self.dpb:
                        raise UnsupportedStream("inter slice without a reference")
                    kind = "B" if slice_type % 5 == 1 else "P"
                    self._decode_slice_p(rbsp, state, db=db, slice_id=sid,
                                         is_b=kind == "B", ref_idc=ref_idc)
                else:
                    raise UnsupportedStream(f"slice type {slice_type}")
        if kind is None:
            raise UnsupportedStream("no slice in access unit")
        y, cb, cr = (p.astype(np.uint8) for p in state)
        if db is not None and db.any_enabled:
            # the FILTERED picture is both the output and the reference
            # for the next P picture (spec 8.7 feeds the DPB)
            deblock_frame(y, cb, cr, db)
        is_ref = ref_idc_pic != 0
        if kind == "I":
            self.dpb = []  # IDR resets the DPB (8.2.5.1)
            self.dpb_meta = []
            self._cur_frame_num = 0  # IDR frame_num is 0 (7.4.3)
            self._cur_poc_lsb = 0
            # new coded video sequence: keep the display key monotonic
            self._poc_base += self._gop_max_poc + 2
            self._gop_max_poc = 0
        poc = self._compute_poc(kind, is_ref)
        self._gop_max_poc = max(self._gop_max_poc, poc)
        self._cabac_pic = None  # per-picture neighbour grids
        if is_ref:
            # MMCO op-1 drops named short-term refs instead of the
            # sliding window (8.2.5.4.1; x264 b-pyramid uses this)
            mmco = getattr(self, "_pending_mmco", None)
            self._pending_mmco = None
            if mmco:
                max_fn = 1 << self.sps["log2_mfn"]
                cur_fn = self._cur_frame_num
                for diff in mmco:
                    pnx = cur_fn - diff  # may be negative (wrap domain)
                    for i, m in enumerate(self.dpb_meta):
                        fn = m["fn"]
                        pn = fn - max_fn if fn > cur_fn else fn
                        if pn == pnx:
                            del self.dpb[i]
                            del self.dpb_meta[i]
                            break
            # colocated motion for B spatial direct (8.4.1.2.2): slot-A
            # mv/refidx = L0 if present else L1
            use0 = self._pic_ref0 >= 0
            refcol = np.where(use0, self._pic_ref0, self._pic_ref1)
            mvcol = np.where(use0[:, :, None], db.mvs, db.mvs1)
            self.dpb.insert(0, (y, cb, cr))
            self.dpb_meta.insert(0, {
                "fn": self._cur_frame_num, "pid": self._pic_seq,
                "poc": poc, "refcol": refcol, "mvcol": mvcol,
            })
            if not mmco:
                del self.dpb[self.sps.get("max_refs", 1):]
                del self.dpb_meta[self.sps.get("max_refs", 1):]
            self._dpb_pad = [None] * len(self.dpb)
        self._pic_seq += 1
        self._pic_ref0 = self._pic_ref1 = None
        w, h = self.sps["width"], self.sps["height"]
        frame = (y[:h, :w], cb[:(h + 1) // 2, :(w + 1) // 2],
                 cr[:(h + 1) // 2, :(w + 1) // 2])
        self._outq.append((self._poc_base + poc, self._outseq, frame))
        self._outseq += 1
        if len(self._outq) > self._reorder_delay():
            self._outq.sort(key=lambda t: (t[0], t[1]))
            return self._outq.pop(0)[2]
        return None

    # -- P slice -----------------------------------------------------------

    def _decode_slice_p(self, rbsp: bytes, state, db=None, slice_id: int = 0,
                        is_b: bool = False, ref_idc: int = 1):
        from ultragrid_tpu_torch.ops.h264_bslice import (b_list_init, col_zero,
                                                   direct_corner,
                                                   direct_ref_indices,
                                                   implicit_weights,
                                                   min_positive)

        sps, pps = self.sps, self.pps
        r = BitReader(rbsp)
        first_mb = r.ue()
        r.ue()  # slice_type (already known P/B)
        r.ue()  # pps id
        fnum = r.u(sps["log2_mfn"])  # frame_num
        self._cur_frame_num = fnum
        if sps.get("poc_type", 2) == 0:
            self._cur_poc_lsb = r.u(sps["log2_poc"])  # pic_order_cnt_lsb
        cur_poc = self._poc_preview(fnum)
        if is_b:
            if not r.u(1):  # direct_spatial_mv_pred_flag
                raise UnsupportedStream("temporal direct")
            if not sps.get("direct_8x8", 1):
                raise UnsupportedStream("direct_8x8_inference_flag=0")
        l0_active = pps.get("l0_default", 1)
        l1_active = pps.get("l1_default", 1)
        if r.u(1):  # num_ref_idx_active_override_flag
            l0_active = r.ue() + 1
            if is_b:
                l1_active = r.ue() + 1
        max_fn = 1 << sps["log2_mfn"]
        if is_b:
            i0, i1 = b_list_init(self.dpb_meta, cur_poc)
            l0map = _parse_ref_mod_l0(r, len(self.dpb), self.dpb_meta, fnum,
                                      max_fn, l0_active, init=i0)
            l1map = _parse_ref_mod_l0(r, len(self.dpb), self.dpb_meta, fnum,
                                      max_fn, l1_active, init=i1)
        else:
            l0map = _parse_ref_mod_l0(r, len(self.dpb), self.dpb_meta, fnum,
                                      max_fn, l0_active)
            l1map = []
            l1_active = 0
        wp = wp1 = None
        wbidc = pps.get("weighted_bipred", 0) if is_b else 0
        if not is_b and pps.get("weighted_pred"):
            wp = _parse_pred_weights_l0(r, l0_active)
        elif is_b and wbidc == 1:
            wp, wp1 = _parse_pred_weights_l0(r, l0_active, l1_active)
        if ref_idc:  # dec_ref_pic_marking only on reference pictures (7.3.3)
            if r.u(1):  # adaptive_ref_pic_marking_mode_flag
                # MMCO (8.2.5.4) — x264's b-pyramid manages the window
                # with op 1 (drop one short-term ref) instead of sliding
                ops = []
                while True:
                    op = r.ue()
                    if op == 0:
                        break
                    if op != 1:
                        raise UnsupportedStream(f"MMCO op {op}")
                    ops.append(r.ue() + 1)  # difference_of_pic_nums
                self._pending_mmco = ops
        # colocated picture (RefPicList1[0]) motion, for spatial direct
        colmeta = self.dpb_meta[l1map[0]] if is_b and l1map else None
        qp = pps["init_qp"] + r.se()
        dbf_idc, dbf_offa, dbf_offb = _parse_dbf(r, pps)
        mbw, mbh = sps["mb_w"], sps["mb_h"]
        y, cbp_, crp = state
        if first_mb % mbw:
            raise UnsupportedStream("slices must start at an MB row")
        my0 = first_mb // mbw
        nnz_l = db.nnz if db is not None else np.zeros((mbh * 4, mbw * 4), np.int64)
        nnz_c = [np.zeros((mbh * 2, mbw * 2), np.int64) for _ in range(2)]
        # motion state at 4x4 granularity (partition support; spec 6.4.11).
        # ref4/ref4b keep per-list ref INDICES (MV prediction compares
        # indices, 8.4.1.3) and live picture-wide on self so the colocated
        # snapshot for B spatial direct sees every slice; the deblock grids
        # get PICTURE IDS instead — with a modified ref list two indices
        # can name the same picture and bS must see them as equal (8.7.2.1
        # compares reference pictures)
        mv4 = db.mvs if db is not None else np.zeros((mbh * 4, mbw * 4, 2), np.int64)
        mv4b = db.mvs1 if db is not None else np.zeros((mbh * 4, mbw * 4, 2), np.int64)
        if self._pic_ref0 is None:
            self._pic_ref0 = np.full((mbh * 4, mbw * 4), -1, np.int64)
            self._pic_ref1 = np.full((mbh * 4, mbw * 4), -1, np.int64)
        ref4 = self._pic_ref0
        ref4b = self._pic_ref1
        pid4 = db.refs if db is not None else None
        pid4b = db.refs1 if db is not None else None
        dec4 = np.zeros((mbh * 4, mbw * 4), bool)
        # intra-NxN-in-P state (same semantics as the I-slice grids)
        i4mode = np.full((mbh * 4, mbw * 4), 2, np.int64)
        avail4 = np.zeros((mbh * 4, mbw * 4), bool)
        done4 = np.zeros((mbh * 4, mbw * 4), bool)

        def record(my, mx, *, intra=False, t8x8=False):
            if db is None:
                return
            db.decoded[my, mx] = True
            db.intra[my, mx] = intra
            db.qp[my, mx] = qp
            db.slice_id[my, mx] = slice_id
            db.idc[my, mx] = dbf_idc
            db.offa[my, mx] = dbf_offa
            db.offb[my, mx] = dbf_offb
            db.t8x8[my, mx] = t8x8

        last_nz = len(rbsp) - 1
        while last_nz >= 0 and rbsp[last_nz] == 0:
            last_nz -= 1
        stop_pos = last_nz * 8 + (
            7 - ((rbsp[last_nz] & -rbsp[last_nz]).bit_length() - 1))

        def nc_of(nn, gx, gy, gy_min):
            na = nn[gy, gx - 1] if gx > 0 else None
            nb = nn[gy - 1, gx] if gy > gy_min else None
            if na is not None and nb is not None:
                return (int(na) + int(nb) + 1) >> 1
            if na is not None:
                return int(na)
            if nb is not None:
                return int(nb)
            return 0

        pads = self._dpb_pad

        def refp(di):
            if pads[di] is None:
                pads[di] = [tuple(pad_ref(p) for p in self.dpb[di]), None]
            return pads[di]

        def get_halfp(di):
            ent = refp(di)
            if ent[1] is None:
                ent[1] = half_planes(ent[0][0])
            return ent[1]

        def mc_one(lmap, ri, gy, gx, pw, ph, mvx, mvy, wpt):
            """One list's clipped prediction for a partition -> (luma
            [ph*4, pw*4], [cb, cr] halved); explicit weights applied."""
            di = lmap[ri]
            ry, rcb, rcr = refp(di)[0]
            hp = get_halfp(di) if ((mvx | mvy) & 3) else None
            mc = mc_luma(ry, gx * 4, gy * 4, mvx, mvy, w=pw * 4, h=ph * 4,
                         halfp=hp)
            if wpt is not None:
                w_, o_ = wpt["luma"][ri]
                mc = _weight_pred(mc, w_, o_, wpt["ld"])
            cs = []
            for ci, refc in ((0, rcb), (1, rcr)):
                mcc = mc_chroma(refc, gx * 2, gy * 2, mvx, mvy,
                                w=pw * 2, h=ph * 2)
                if wpt is not None:
                    w_, o_ = wpt["chroma"][ri][ci]
                    mcc = _weight_pred(mcc, w_, o_, wpt["cd"])
                cs.append(mcc)
            return mc, cs

        def part_pred(pred16, predc, mx, my, gy, gx, pw, ph, mvx, mvy, ri):
            """Motion-compensate one L0 partition into the MB-local pred
            buffers (luma [16,16] at 4x4-grid (gy,gx), chroma halved)."""
            ly, lx = (gy - my * 4) * 4, (gx - mx * 4) * 4
            mc, cs = mc_one(l0map, ri, gy, gx, pw, ph, mvx, mvy, wp)
            pred16[ly:ly + ph * 4, lx:lx + pw * 4] = mc
            cy2, cx2 = ly // 2, lx // 2
            for ci in range(2):
                predc[ci][cy2:cy2 + ph * 2, cx2:cx2 + pw * 2] = cs[ci]

        def part_pred_b(pred16, predc, mx, my, gy, gx, pw, ph,
                        mv0, mv1, ri0, ri1):
            """B partition prediction: mono L0/L1, or bipred combined by
            the default average / implicit POC weights / explicit table
            (8.4.2.3).  ``ri < 0`` marks an unused list."""
            ly, lx = (gy - my * 4) * 4, (gx - mx * 4) * 4
            cy2, cx2 = ly // 2, lx // 2
            if ri1 < 0:
                mc, cs = mc_one(l0map, ri0, gy, gx, pw, ph, mv0[0], mv0[1],
                                wp)
            elif ri0 < 0:
                mc, cs = mc_one(l1map, ri1, gy, gx, pw, ph, mv1[0], mv1[1],
                                wp1)
            else:
                # bipred: per-list clipped predictions, then combine —
                # explicit combines UNWEIGHTED samples with both tables'
                # weights, so fetch the raw predictions here
                m0, c0 = mc_one(l0map, ri0, gy, gx, pw, ph, mv0[0], mv0[1],
                                None)
                m1, c1 = mc_one(l1map, ri1, gy, gx, pw, ph, mv1[0], mv1[1],
                                None)
                if wbidc == 2:
                    p0 = self.dpb_meta[l0map[ri0]]["poc"]
                    p1 = self.dpb_meta[l1map[ri1]]["poc"]
                    w0, w1 = implicit_weights(cur_poc, p0, p1)
                    mc = np.clip((m0 * w0 + m1 * w1 + 32) >> 6, 0, 255)
                    cs = [np.clip((c0[ci] * w0 + c1[ci] * w1 + 32) >> 6,
                                  0, 255) for ci in range(2)]
                elif wbidc == 1:
                    ld = wp["ld"]
                    wl0, ol0 = wp["luma"][ri0]
                    wl1, ol1 = wp1["luma"][ri1]
                    mc = np.clip(
                        ((m0 * wl0 + m1 * wl1 + (1 << ld)) >> (ld + 1))
                        + ((ol0 + ol1 + 1) >> 1), 0, 255)
                    cd = wp["cd"]
                    cs = []
                    for ci in range(2):
                        wc0, oc0 = wp["chroma"][ri0][ci]
                        wc1, oc1 = wp1["chroma"][ri1][ci]
                        cs.append(np.clip(
                            ((c0[ci] * wc0 + c1[ci] * wc1 + (1 << cd))
                             >> (cd + 1)) + ((oc0 + oc1 + 1) >> 1), 0, 255))
                else:
                    mc = (m0 + m1 + 1) >> 1
                    cs = [(c0[ci] + c1[ci] + 1) >> 1 for ci in range(2)]
            pred16[ly:ly + ph * 4, lx:lx + pw * 4] = mc
            for ci in range(2):
                predc[ci][cy2:cy2 + ph * 2, cx2:cx2 + pw * 2] = cs[ci]

        def fill4(gy, gx, pw, ph, mvx, mvy, ri):
            mv4[gy:gy + ph, gx:gx + pw] = (mvx, mvy)
            ref4[gy:gy + ph, gx:gx + pw] = ri
            if pid4 is not None:
                pid4[gy:gy + ph, gx:gx + pw] = \
                    self.dpb_meta[l0map[ri]]["pid"]
            dec4[gy:gy + ph, gx:gx + pw] = True

        def fill4_b(gy, gx, pw, ph, mv0, mv1, ri0, ri1):
            mv4[gy:gy + ph, gx:gx + pw] = mv0 if ri0 >= 0 else (0, 0)
            ref4[gy:gy + ph, gx:gx + pw] = ri0
            mv4b[gy:gy + ph, gx:gx + pw] = mv1 if ri1 >= 0 else (0, 0)
            ref4b[gy:gy + ph, gx:gx + pw] = ri1
            if pid4 is not None:
                pid4[gy:gy + ph, gx:gx + pw] = (
                    self.dpb_meta[l0map[ri0]]["pid"] if ri0 >= 0 else -1)
                pid4b[gy:gy + ph, gx:gx + pw] = (
                    self.dpb_meta[l1map[ri1]]["pid"] if ri1 >= 0 else -1)
            dec4[gy:gy + ph, gx:gx + pw] = True

        def recon_mb(mx, my, pred16, predc, luma_res, chroma_res):
            px, py = mx * 16, my * 16
            y[py:py + 16, px:px + 16] = np.clip(pred16 + luma_res, 0, 255)
            cx, cy = mx * 8, my * 8
            for ci, plane in enumerate((cbp_, crp)):
                plane[cy:cy + 8, cx:cx + 8] = np.clip(
                    predc[ci] + chroma_res[ci], 0, 255)

        zero16 = np.zeros((16, 16), np.int64)
        zero8 = [np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64)]

        def read_refidx(rr, active=None):
            n = l0_active if active is None else active
            if n <= 1:
                return 0
            ri = (1 - rr.u(1)) if n == 2 else rr.ue()  # te(v), 9.1.1
            if ri >= n:
                raise UnsupportedStream(f"ref_idx {ri}")
            return ri

        def direct_block(mx, my):
            """Derive and apply B_Skip / B_Direct_16x16 for one MB;
            returns the (pred16, predc) buffers (grids filled)."""
            gy0, gx0 = my * 4, mx * 4
            ri0, ri1 = direct_ref_indices(ref4, ref4b, gy0, gx0, my0, mbw,
                                          dec4)
            if ri0 < 0 and ri1 < 0:
                ri0 = ri1 = 0
                mvp0 = mvp1 = (0, 0)
                zero_pred = True
            else:
                zero_pred = False
                mvp0 = mv_pred4(mv4, ref4, dec4, gy0, gx0, 4, ri0, my0,
                                mbw) if ri0 >= 0 else (0, 0)
                mvp1 = mv_pred4(mv4b, ref4b, dec4, gy0, gx0, 4, ri1, my0,
                                mbw) if ri1 >= 0 else (0, 0)
            pred16 = np.zeros((16, 16), np.int64)
            predc = [np.zeros((8, 8), np.int64) for _ in range(2)]
            for q in range(4):
                qy, qx = gy0 + (q // 2) * 2, gx0 + (q % 2) * 2
                cy_, cx_ = direct_corner(gy0, gx0, q, True, 0, 0)
                cz = (not zero_pred) and col_zero(colmeta, cy_, cx_)
                m0 = (0, 0) if (cz and ri0 == 0) or zero_pred else mvp0
                m1 = (0, 0) if (cz and ri1 == 0) or zero_pred else mvp1
                if zero_pred:
                    m0 = m1 = (0, 0)
                part_pred_b(pred16, predc, mx, my, qy, qx, 2, 2,
                            m0, m1, ri0, ri1)
                fill4_b(qy, qx, 2, 2, m0, m1, ri0, ri1)
            return pred16, predc

        def b_motion(mx, my, mb_type):
            """Decode one B inter MB's motion + prediction (7.3.5.1/.2,
            Tables 7-14/7-18).  Returns (pred16, predc, small_parts)."""
            gy0, gx0 = my * 4, mx * 4
            if mb_type == 0:  # B_Direct_16x16
                pred16, predc = direct_block(mx, my)
                return pred16, predc, False
            pred16 = np.zeros((16, 16), np.int64)
            predc = [np.zeros((8, 8), np.int64) for _ in range(2)]
            if mb_type <= 3:  # 16x16: 1 L0, 2 L1, 3 Bi
                use0 = mb_type in (1, 3)
                use1 = mb_type in (2, 3)
                ri0 = read_refidx(r) if use0 else -1
                ri1 = read_refidx(r, l1_active) if use1 else -1
                mv0 = mv1 = (0, 0)
                if use0:
                    pmx, pmy = mv_pred4(mv4, ref4, dec4, gy0, gx0, 4, ri0,
                                        my0, mbw)
                    mv0 = (pmx + r.se(), pmy + r.se())
                if use1:
                    pmx, pmy = mv_pred4(mv4b, ref4b, dec4, gy0, gx0, 4, ri1,
                                        my0, mbw)
                    mv1 = (pmx + r.se(), pmy + r.se())
                part_pred_b(pred16, predc, mx, my, gy0, gx0, 4, 4,
                            mv0, mv1, ri0, ri1)
                fill4_b(gy0, gx0, 4, 4, mv0, mv1, ri0, ri1)
                return pred16, predc, False
            if mb_type <= 21:  # two-partition types (Table 7-14)
                # (modeL of part0, part1): 0 = L0, 1 = L1, 2 = Bi
                pair = _B_PAIR[(mb_type - 4) // 2]
                if (mb_type - 4) % 2 == 0:
                    geo = [(gy0, gx0, 4, 2, "16x8_0"),
                           (gy0 + 2, gx0, 4, 2, "16x8_1")]
                else:
                    geo = [(gy0, gx0, 2, 4, "8x16_0"),
                           (gy0, gx0 + 2, 2, 4, "8x16_1")]
                use0 = [pair[p] in (0, 2) for p in range(2)]
                use1 = [pair[p] in (1, 2) for p in range(2)]
                ri0 = [read_refidx(r) if use0[p] else -1 for p in range(2)]
                ri1 = [read_refidx(r, l1_active) if use1[p] else -1
                       for p in range(2)]
                md0 = [(r.se(), r.se()) if use0[p] else (0, 0)
                       for p in range(2)]
                md1 = [(r.se(), r.se()) if use1[p] else (0, 0)
                       for p in range(2)]
                mvs0 = [None, None]
                mvs1 = [None, None]
                for p, (gy, gx, pw, ph, shape) in enumerate(geo):
                    mv0 = mv1 = (0, 0)
                    if use0[p]:
                        pmx, pmy = mv_pred4(mv4, ref4, dec4, gy, gx, pw,
                                            ri0[p], my0, mbw, shape)
                        mv0 = (pmx + md0[p][0], pmy + md0[p][1])
                    if use1[p]:
                        pmx, pmy = mv_pred4(mv4b, ref4b, dec4, gy, gx, pw,
                                            ri1[p], my0, mbw, shape)
                        mv1 = (pmx + md1[p][0], pmy + md1[p][1])
                    part_pred_b(pred16, predc, mx, my, gy, gx, pw, ph,
                                mv0, mv1, ri0[p], ri1[p])
                    fill4_b(gy, gx, pw, ph, mv0, mv1, ri0[p], ri1[p])
                    mvs0[p], mvs1[p] = mv0, mv1
                return pred16, predc, False
            if mb_type != 22:
                raise UnsupportedStream(f"B mb_type {mb_type}")
            # B_8x8 (7.3.5.2): subs, then all ref_l0, ref_l1, mvd_l0, mvd_l1
            subs = [r.ue() for _ in range(4)]
            if any(t > 12 for t in subs):
                raise UnsupportedStream(f"B sub_mb_type {subs}")
            su0 = [_B_SUB[t][1] in (0, 2) if t else False for t in subs]
            su1 = [_B_SUB[t][1] in (1, 2) if t else False for t in subs]
            ri0 = [read_refidx(r) if su0[b] else -1 for b in range(4)]
            ri1 = [read_refidx(r, l1_active) if su1[b] else -1
                   for b in range(4)]
            md0 = [[(r.se(), r.se()) for _ in _SUB_PARTS[_B_SUB[subs[b]][0]]]
                   if su0[b] else None for b in range(4)]
            md1 = [[(r.se(), r.se()) for _ in _SUB_PARTS[_B_SUB[subs[b]][0]]]
                   if su1[b] else None for b in range(4)]
            small = False
            # direct parameters shared by every direct 8x8 of this MB
            dri0, dri1 = direct_ref_indices(ref4, ref4b, gy0, gx0, my0,
                                            mbw, dec4)
            dzero = dri0 < 0 and dri1 < 0
            if dzero:
                dri0 = dri1 = 0
                dmvp0 = dmvp1 = (0, 0)
            else:
                dmvp0 = mv_pred4(mv4, ref4, dec4, gy0, gx0, 4, dri0, my0,
                                 mbw) if dri0 >= 0 else (0, 0)
                dmvp1 = mv_pred4(mv4b, ref4b, dec4, gy0, gx0, 4, dri1, my0,
                                 mbw) if dri1 >= 0 else (0, 0)
            for b in range(4):
                by, bx = gy0 + (b // 2) * 2, gx0 + (b % 2) * 2
                if subs[b] == 0:  # B_Direct_8x8
                    cy_, cx_ = direct_corner(gy0, gx0, b, True, 0, 0)
                    cz = (not dzero) and col_zero(colmeta, cy_, cx_)
                    m0 = (0, 0) if dzero or (cz and dri0 == 0) else dmvp0
                    m1 = (0, 0) if dzero or (cz and dri1 == 0) else dmvp1
                    part_pred_b(pred16, predc, mx, my, by, bx, 2, 2,
                                m0, m1, dri0, dri1)
                    fill4_b(by, bx, 2, 2, m0, m1, dri0, dri1)
                    continue
                shp, _mode = _B_SUB[subs[b]]
                if shp != 0:
                    small = True
                k0 = k1 = 0
                for dy, dx, pw, ph in _SUB_PARTS[shp]:
                    gy, gx = by + dy, bx + dx
                    mv0 = mv1 = (0, 0)
                    if su0[b]:
                        pmx, pmy = mv_pred4(mv4, ref4, dec4, gy, gx, pw,
                                            ri0[b], my0, mbw)
                        mv0 = (pmx + md0[b][k0][0], pmy + md0[b][k0][1])
                        k0 += 1
                    if su1[b]:
                        pmx, pmy = mv_pred4(mv4b, ref4b, dec4, gy, gx, pw,
                                            ri1[b], my0, mbw)
                        mv1 = (pmx + md1[b][k1][0], pmy + md1[b][k1][1])
                        k1 += 1
                    part_pred_b(pred16, predc, mx, my, gy, gx, pw, ph,
                                mv0, mv1, ri0[b], ri1[b])
                    fill4_b(gy, gx, pw, ph, mv0, mv1, ri0[b], ri1[b])
            return pred16, predc, small

        mb_addr = first_mb
        n_mbs = mbw * mbh
        intra_off = 23 if is_b else 5
        while mb_addr < n_mbs and r.pos < stop_pos:
            skip_run = r.ue()
            for _ in range(skip_run):
                my, mx = mb_addr // mbw, mb_addr % mbw
                if is_b:  # B_Skip = spatial direct, no residual
                    pred16, predc = direct_block(mx, my)
                else:
                    mvx, mvy = skip_mv4(mv4, ref4, dec4, mx, my, my0, mbw)
                    pred16 = np.zeros((16, 16), np.int64)
                    predc = [np.zeros((8, 8), np.int64) for _ in range(2)]
                    part_pred(pred16, predc, mx, my, my * 4, mx * 4, 4, 4,
                              mvx, mvy, 0)
                    fill4(my * 4, mx * 4, 4, 4, mvx, mvy, 0)
                recon_mb(mx, my, pred16, predc, zero16, zero8)
                nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                done4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                avail4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                record(my, mx)
                mb_addr += 1
            if mb_addr >= n_mbs or r.pos >= stop_pos:
                break
            my, mx = mb_addr // mbw, mb_addr % mbw
            mb_addr += 1
            qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
            vy, vc = _vmat(qp), _vmat(qpc)
            mb_type = r.ue()
            if mb_type < intra_off:  # inter MB
                gy0, gx0 = my * 4, mx * 4
                small_parts = False
                if is_b:
                    pred16, predc, small_parts = b_motion(mx, my, mb_type)
                else:
                    pred16 = np.zeros((16, 16), np.int64)
                    predc = [np.zeros((8, 8), np.int64) for _ in range(2)]
                    if mb_type == 0:  # P_L0_16x16
                        ri = read_refidx(r)
                        pmx, pmy = mv_pred4(mv4, ref4, dec4, gy0, gx0, 4, ri,
                                            my0, mbw)
                        mvx, mvy = pmx + r.se(), pmy + r.se()
                        part_pred(pred16, predc, mx, my, gy0, gx0, 4, 4,
                                  mvx, mvy, ri)
                        fill4(gy0, gx0, 4, 4, mvx, mvy, ri)
                    elif mb_type in (1, 2):  # P_L0_L0_16x8 / 8x16
                        if mb_type == 1:
                            geo = [(gy0, gx0, 4, 2, "16x8_0"),
                                   (gy0 + 2, gx0, 4, 2, "16x8_1")]
                        else:
                            geo = [(gy0, gx0, 2, 4, "8x16_0"),
                                   (gy0, gx0 + 2, 2, 4, "8x16_1")]
                        ris = [read_refidx(r) for _ in geo]
                        for (gy, gx, pw, ph, shape), ri in zip(geo, ris):
                            pmx, pmy = mv_pred4(mv4, ref4, dec4, gy, gx, pw,
                                                ri, my0, mbw, shape)
                            mvx, mvy = pmx + r.se(), pmy + r.se()
                            part_pred(pred16, predc, mx, my, gy, gx, pw, ph,
                                      mvx, mvy, ri)
                            fill4(gy, gx, pw, ph, mvx, mvy, ri)
                    else:  # P_8x8 (3) / P_8x8ref0 (4)
                        subs = [r.ue() for _ in range(4)]
                        if any(t > 3 for t in subs):
                            raise UnsupportedStream(f"sub_mb_type {subs}")
                        small_parts = any(s != 0 for s in subs)
                        if mb_type == 3:
                            ris = [read_refidx(r) for _ in range(4)]
                        else:
                            ris = [0, 0, 0, 0]
                        for b in range(4):
                            by, bx = gy0 + (b // 2) * 2, gx0 + (b % 2) * 2
                            for dy, dx, pw, ph in _SUB_PARTS[subs[b]]:
                                gy, gx = by + dy, bx + dx
                                pmx, pmy = mv_pred4(mv4, ref4, dec4, gy, gx,
                                                    pw, ris[b], my0, mbw)
                                mvx, mvy = pmx + r.se(), pmy + r.se()
                                part_pred(pred16, predc, mx, my, gy, gx, pw,
                                          ph, mvx, mvy, ris[b])
                                fill4(gy, gx, pw, ph, mvx, mvy, ris[b])
                cbp_code = r.ue()
                if cbp_code >= len(_CBP_INTER):
                    raise UnsupportedStream("bad inter cbp")
                cbp = _CBP_INTER[cbp_code]
                cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
                if cbp_chroma == 3:
                    raise UnsupportedStream("bad chroma cbp")
                # transform_size_8x8_flag (7.3.5): after cbp, before dqp;
                # only when luma is coded and no partition is below 8x8
                # (direct MBs qualify via direct_8x8_inference, enforced 1)
                t8 = False
                if (cbp_luma and pps.get("transform_8x8")
                        and not small_parts):
                    t8 = r.u(1) == 1
                luma_res = np.zeros((16, 16), np.int64)
                cres = zero8
                if cbp:
                    qp = qp + r.se()
                    qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
                    vy, vc = _vmat(qp), _vmat(qpc)
                if cbp_luma or cbp_chroma:
                    if t8:
                        from ultragrid_tpu_torch.ops.h264_8x8 import recon_res8

                        for b in range(4):
                            has = bool(cbp_luma & (1 << b))
                            zz64 = decode_luma8x8_block_cavlc(
                                r, b, mx, my, my0, nnz_l, nc_of, has)
                            if has:
                                py8, px8 = (b // 2) * 8, (b % 2) * 8
                                luma_res[py8:py8 + 8, px8:px8 + 8] = (
                                    recon_res8(zz64, qp))
                    else:
                        for bi, (bx, by) in enumerate(H._BLK_ORDER):
                            gx, gy = mx * 4 + bx, my * 4 + by
                            if cbp_luma & (1 << (bi // 4)):
                                nc = nc_of(nnz_l, gx, gy, my0 * 4)
                                zz = decode_cavlc_block(r, nc, 16)
                                nnz_l[gy, gx] = int(np.count_nonzero(zz))
                                d = _dezigzag(zz) * vy << (qp // 6)
                                luma_res[by * 4:by * 4 + 4,
                                         bx * 4:bx * 4 + 4] = (
                                    (_itransform4(d) + 32) >> 6)
                            else:
                                nnz_l[gy, gx] = 0
                    cres = chroma_residuals_p(
                        r, cbp_chroma, mx, my, vc, qpc, nnz_c, nc_of, my0)
                else:
                    nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                    for nn in nnz_c:
                        nn[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
                recon_mb(mx, my, pred16, predc, luma_res, cres)
                done4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                avail4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                i4mode[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 2
                record(my, mx, t8x8=t8)
                continue
            it = mb_type - intra_off  # intra-in-P/B (Tables 7-13/7-14)
            ref4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
            mv4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
            dec4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
            if it == 25:
                raise UnsupportedStream("I_PCM in P not supported")
            if it == 0:  # I_NxN in P
                if pps.get("transform_8x8") and r.u(1):
                    qp = _decode_intra8x8_cavlc(
                        r, mx, my, my0, qp, pps, mbw, y, (cbp_, crp),
                        nnz_l, nnz_c, nc_of, i4mode, avail4, done4)
                    record(my, mx, intra=True, t8x8=True)
                else:
                    qp = _decode_intra4x4_cavlc(
                        r, mx, my, my0, qp, pps, mbw, y, (cbp_, crp),
                        nnz_l, nnz_c, nc_of, i4mode, avail4, done4)
                    record(my, mx, intra=True)
                continue
            if not 1 <= it <= 24:
                raise UnsupportedStream(f"intra-in-P mb_type {it}")
            qp = self._decode_i16_in_p(
                r, it, mx, my, my0, qp, state, nnz_l, nnz_c, nc_of)
            i4mode[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 2
            avail4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
            done4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
            record(my, mx, intra=True)
        return state

    def _decode_i16_in_p(self, r, t_code, mx, my, my0, qp, state,
                         nnz_l, nnz_c, nc_of):
        """I_16x16 macroblock inside a P slice (DC/V/H/Plane prediction from
        reconstructed neighbours) — mirrors the intra decoder's I_16x16
        branch."""
        sps, pps = self.sps, self.pps
        y, cbp_, crp = state
        t = t_code - 1
        pred_mode = t % 4
        cbp_chroma = (t // 4) % 3
        cbp_luma = 15 if t >= 12 else 0
        chroma_mode = r.ue()
        qp = qp + r.se()
        qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
        vy, vc = _vmat(qp), _vmat(qpc)
        mbw = sps["mb_w"]

        nc = nc_of(nnz_l, mx * 4, my * 4, my0 * 4)
        dc_zz = decode_cavlc_block(r, nc, 16)
        ac = np.zeros((4, 4, 16), np.int64)
        if cbp_luma:
            for bx, by in H._BLK_ORDER:
                gx, gy = mx * 4 + bx, my * 4 + by
                nc = nc_of(nnz_l, gx, gy, my0 * 4)
                zz = decode_cavlc_block(r, nc, 15)
                ac[by, bx, 1:] = zz
                nnz_l[gy, gx] = int(np.count_nonzero(zz))
        else:
            nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0

        left = y[my * 16:my * 16 + 16, mx * 16 - 1] if mx > 0 else None
        top = y[my * 16 - 1, mx * 16:mx * 16 + 16] if my > my0 else None
        if pred_mode == 0:
            pred16 = np.repeat(top[None, :].astype(np.int64), 16, axis=0)
        elif pred_mode == 1:
            pred16 = np.repeat(left[:, None].astype(np.int64), 16, axis=1)
        elif pred_mode == 2:
            if left is not None and top is not None:
                dcv = (int(left.sum()) + int(top.sum()) + 16) >> 5
            elif left is not None:
                dcv = (int(left.sum()) + 8) >> 4
            elif top is not None:
                dcv = (int(top.sum()) + 8) >> 4
            else:
                dcv = 128
            pred16 = np.full((16, 16), dcv, np.int64)
        else:
            tl = int(y[my * 16 - 1, mx * 16 - 1])
            pred16 = _pred16_plane(top.astype(np.int64), left.astype(np.int64), tl)
        f = _ihadamard4(_dezigzag(dc_zz))
        v00 = int(vy[0, 0])
        if qp >= 12:
            dcs = (f * v00) << (qp // 6 - 2)
        else:
            dcs = (f * v00 + (1 << (1 - qp // 6))) >> (2 - qp // 6)
        for by in range(4):
            for bx in range(4):
                d = _dezigzag(ac[by, bx]) * vy << (qp // 6)
                d[0, 0] = dcs[by, bx]
                res = (_itransform4(d) + 32) >> 6
                y[my * 16 + by * 4:my * 16 + by * 4 + 4,
                  mx * 16 + bx * 4:mx * 16 + bx * 4 + 4] = np.clip(
                    pred16[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + res, 0, 255)
        cres = chroma_residuals_p(r, cbp_chroma, mx, my, vc, qpc,
                                  nnz_c, nc_of, my0)
        for ci, plane in enumerate((cbp_, crp)):
            x0, y0 = mx * 8, my * 8
            lcol = plane[y0:y0 + 8, x0 - 1].astype(np.int64) if mx > 0 else None
            trow = plane[y0 - 1, x0:x0 + 8].astype(np.int64) if my > my0 else None
            if chroma_mode == 0:
                preds = np.zeros((8, 8), np.int64)
                for by in range(2):
                    for bx in range(2):
                        lc = lcol[by * 4:by * 4 + 4] if lcol is not None else None
                        tr = trow[bx * 4:bx * 4 + 4] if trow is not None else None
                        use_l, use_t = lc is not None, tr is not None
                        if bx == 1 and by == 0 and tr is not None:
                            use_l = False
                        if bx == 0 and by == 1 and lc is not None:
                            use_t = False
                        if use_l and use_t:
                            v = (int(lc.sum()) + int(tr.sum()) + 4) >> 3
                        elif use_l:
                            v = (int(lc.sum()) + 2) >> 2
                        elif use_t:
                            v = (int(tr.sum()) + 2) >> 2
                        else:
                            v = 128
                        preds[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = v
            elif chroma_mode == 1:
                preds = np.repeat(lcol[:, None], 8, axis=1)
            elif chroma_mode == 2:
                preds = np.repeat(trow[None, :], 8, axis=0)
            else:
                tl = int(plane[y0 - 1, x0 - 1])
                preds = _pred8_chroma_plane(trow, lcol, tl)
            plane[y0:y0 + 8, x0:x0 + 8] = np.clip(preds + cres[ci], 0, 255)
        return qp


def chroma_residuals_p(r, cbp_chroma, mx, my, vc, qpc, nnz_c, nc_of, my0):
    """Chroma DC+AC residual (shared by P inter and intra-in-P paths;
    same syntax as the intra decoder's chroma_residuals closure)."""
    cdc = [np.zeros(4, np.int64), np.zeros(4, np.int64)]
    cac = [np.zeros((2, 2, 16), np.int64) for _ in range(2)]
    if cbp_chroma:
        for ci in range(2):
            cdc[ci] = decode_cavlc_block(r, -1, 4)
    if cbp_chroma == 2:
        for ci in range(2):
            for bx, by in ((0, 0), (1, 0), (0, 1), (1, 1)):
                gx, gy = mx * 2 + bx, my * 2 + by
                nc = nc_of(nnz_c[ci], gx, gy, my0 * 2)
                zz = decode_cavlc_block(r, nc, 15)
                cac[ci][by, bx, 1:] = zz
                nnz_c[ci][gy, gx] = int(np.count_nonzero(zz))
    else:
        for ci in range(2):
            nnz_c[ci][my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
    res = [np.zeros((8, 8), np.int64) for _ in range(2)]
    for ci in range(2):
        fdc = H._H2 @ np.array([[cdc[ci][0], cdc[ci][1]],
                                [cdc[ci][2], cdc[ci][3]]], np.int64) @ H._H2
        v00c = int(vc[0, 0])
        dcsc = ((fdc * v00c) << (qpc // 6)) >> 1
        for by in range(2):
            for bx in range(2):
                d = _dezigzag(cac[ci][by, bx]) * vc << (qpc // 6)
                d[0, 0] = dcsc[by, bx]
                res[ci][by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = (
                    (_itransform4(d) + 32) >> 6)
    return res
