"""CABAC entropy decoding for the own H.264 decoder (spec clause 9.3).

Round-3 verdict ask #2: the own decoder was baseline-CAVLC-only, so
default-configured encoders (libx264 Main/High = CABAC) were reachable
only through the lavc wrapper.  This module adds the arithmetic decoding
engine (9.3.3.2), per-slice context initialization (9.3.1.1, tables in
:mod:`h264_cabac_tables`), the binarizations + context index derivations
for every syntax element of progressive I and P slices with the 4x4
transform, and a slice decoder that drives the same reconstruction
machinery as the CAVLC paths in :mod:`h264_dec`.

Supported envelope (raises :class:`UnsupportedStream` outside it):
progressive Main/High-profile CABAC streams with I/P/B slices (8x8
transform, multi-reference, weighted P with ref-list modification,
spatial-direct B with implicit bipred + b-pyramid/MMCO), arbitrary
partitioning down to 4x4, deblocking; no temporal direct, no
interlace/MBAFF, no slice groups, no scaling lists.  Conformance is
gated by sample-exact decode of libx264-encoded CABAC streams vs
libavcodec in tests/test_h264*.py.

Reference role: the decode half of src/video_decompress/libavcodec.c
(the reference reaches CABAC via FFmpeg; this is a from-scratch
implementation).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.ops import h264 as H
from ultragrid_tpu_torch.ops.h264_cabac_tables import (
    CONTEXT_INIT,
    RANGE_TAB_LPS,
    TRANS_IDX_LPS,
)
from ultragrid_tpu_torch.ops.h264_dec import (
    UnsupportedStream,
    _dezigzag,
    _ihadamard4,
    _itransform4,
    _pred4x4,
    _pred8_chroma_plane,
    _pred16_plane,
    _vmat,
    mc_chroma,
    mc_luma,
    mv_pred4,
    skip_mv4,
)

_RTAB = RANGE_TAB_LPS
_TLPS = TRANS_IDX_LPS

# per-category offsets into the significant/last/level context banks
# (frame-coded; ctxBlockCat 0..4: luma DC, luma AC, luma 4x4, chroma DC,
# chroma AC — Tables 9-40)
_SIG_OFF = (0, 15, 29, 44, 47)
_LVL_OFF = (0, 10, 20, 30, 39)

# contested neighbour-availability conventions (resolved empirically against
# libx264 streams; see tests): cond value used when the neighbour MB is
# outside the picture/slice
_CBP_LUMA_UNAVAIL_A = 0      # 9.3.3.1.1.4 cond for missing LEFT MB
_CBP_LUMA_UNAVAIL_B = 0      # ... for missing TOP MB
_CBF_UNAVAIL_INTRA = 1       # 9.3.3.1.1.9 (intra MB, missing neighbour)
_CBP_CHROMA_UNAVAIL = 0


class CabacEngine:
    """Arithmetic decoding engine (9.3.3.2) + context state."""

    __slots__ = ("data", "pos", "range", "offset", "pstate", "mps")

    def __init__(self, data: bytes, pos: int, table_idx: int, slice_qp: int):
        self.data = data
        self.pos = pos
        mn = CONTEXT_INIT[table_idx].astype(np.int32)
        pre = np.clip(((mn[:, 0] * min(max(slice_qp, 0), 51)) >> 4)
                      + mn[:, 1], 1, 126)
        self.mps = (pre > 63).astype(np.int64)
        self.pstate = np.where(pre <= 63, 63 - pre, pre - 64).astype(np.int64)
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()
        if self.offset >= 510:
            raise UnsupportedStream("CABAC init offset out of range")

    def _bit(self) -> int:
        p = self.pos
        self.pos = p + 1
        bidx = p >> 3
        if bidx >= len(self.data):
            return 0
        return (self.data[bidx] >> (7 - (p & 7))) & 1

    def decision(self, ctx: int) -> int:
        st = int(self.pstate[ctx])
        lps = int(_RTAB[st][(self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - int(self.mps[ctx])
            self.offset -= self.range
            self.range = lps
            if st == 0:
                self.mps[ctx] ^= 1
            self.pstate[ctx] = _TLPS[st]
        else:
            b = int(self.mps[ctx])
            if st < 62:
                self.pstate[ctx] = st + 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return b

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0


# ---------------------------------------------------------------------------
# picture-level context grids shared by the slices of one picture
# ---------------------------------------------------------------------------


class CabacPictureCtx:
    """Neighbour-context state at MB/block granularity (one picture)."""

    def __init__(self, mbw: int, mbh: int):
        self.skip = np.zeros((mbh, mbw), bool)
        self.i16 = np.zeros((mbh, mbw), bool)       # I_16x16 or I_PCM
        self.intra = np.zeros((mbh, mbw), bool)
        self.pcm = np.zeros((mbh, mbw), bool)
        self.chroma_mode = np.zeros((mbh, mbw), np.int64)
        self.cbp_l = np.zeros((mbh, mbw), np.int64)
        self.cbp_c = np.zeros((mbh, mbw), np.int64)
        self.cbf_ldc = np.zeros((mbh, mbw), np.int64)
        self.cbf_l4 = np.zeros((mbh * 4, mbw * 4), np.int64)
        self.cbf_cdc = np.zeros((2, mbh, mbw), np.int64)
        self.cbf_c4 = np.zeros((2, mbh * 2, mbw * 2), np.int64)
        self.absmvd4 = np.zeros((mbh * 4, mbw * 4, 2), np.int64)
        self.absmvd4b = np.zeros((mbh * 4, mbw * 4, 2), np.int64)  # L1
        self.bdirect = np.zeros((mbh, mbw), bool)  # B_Skip/B_Direct_16x16
        self.t8x8 = np.zeros((mbh, mbw), bool)  # transform_size_8x8_flag


# ---------------------------------------------------------------------------
# residual block (9.3.2.3 binarization + 9.3.3.1.3 contexts)
# ---------------------------------------------------------------------------


def _residual_cabac(eng: CabacEngine, cat: int, n_coeffs: int,
                    cbf_inc: int) -> Optional[np.ndarray]:
    """Decode one residual block; returns zig-zag-ordered coefficients of
    length ``n_coeffs`` or None when coded_block_flag == 0."""
    if not eng.decision(85 + 4 * cat + cbf_inc):
        return None
    sig_base = 105 + _SIG_OFF[cat]
    last_base = 166 + _SIG_OFF[cat]
    lvl_base = 227 + _LVL_OFF[cat]
    sig = np.zeros(n_coeffs, bool)
    i = 0
    ended = False
    while i < n_coeffs - 1:
        if eng.decision(sig_base + i):
            sig[i] = True
            if eng.decision(last_base + i):
                ended = True
                break
        i += 1
    if not ended:
        sig[n_coeffs - 1] = True
    return _levels_from_sig(eng, sig, lvl_base, cap=4 - (1 if cat == 3 else 0))


def _residual_cabac8(eng: CabacEngine) -> np.ndarray:
    """ctxBlockCat 5 (luma 8x8, frame-coded): 64-coefficient significance
    map with the Table 9-43 position->ctxIdxInc maps; no coded_block_flag
    (the CBP bit implies coded, 9.3.3.1.1.9)."""
    from ultragrid_tpu_torch.ops.h264_8x8 import LAST8_INC, SIG8_INC

    sig = np.zeros(64, bool)
    i = 0
    ended = False
    while i < 63:
        if eng.decision(402 + int(SIG8_INC[i])):
            sig[i] = True
            if eng.decision(417 + int(LAST8_INC[i])):
                ended = True
                break
        i += 1
    if not ended:
        sig[63] = True
    return _levels_from_sig(eng, sig, 426, cap=4)


def _levels_from_sig(eng: CabacEngine, sig: np.ndarray, lvl_base: int,
                     cap: int) -> np.ndarray:
    """coeff_abs_level_minus1 + sign for a decoded significance map
    (shared by all ctxBlockCats; UEG0 escape at 14)."""
    out = np.zeros(len(sig), np.int64)
    num_eq1 = 0
    num_gt1 = 0
    for pos in np.flatnonzero(sig)[::-1]:
        inc0 = 0 if num_gt1 else min(4, 1 + num_eq1)
        if eng.decision(lvl_base + inc0) == 0:
            level = 1
            num_eq1 += 1
        else:
            incn = 5 + min(cap, num_gt1)
            level = 2
            while level < 15 and eng.decision(lvl_base + incn):
                level += 1
            if level == 15:
                # UEG0 suffix (uCoff = 14), bypass-coded
                j = 0
                while eng.bypass() and j < 30:
                    j += 1
                val = 1
                for _ in range(j):
                    val = (val << 1) | eng.bypass()
                level = 14 + val
            num_gt1 += 1
        if eng.bypass():
            level = -level
        out[pos] = level
    return out


def _read_mvd(eng: CabacEngine, base: int, amvd: int) -> int:
    """mvd component (UEG3 binarization, ctx 9.3.3.1.1.7)."""
    inc = (1 if amvd > 2 else 0) + (1 if amvd > 32 else 0)
    if not eng.decision(base + inc):
        return 0
    mvd = 1
    ctx = 3
    while mvd < 9 and eng.decision(base + ctx):
        if ctx < 6:
            ctx += 1
        mvd += 1
    if mvd >= 9:
        k = 3
        while eng.bypass():
            mvd += 1 << k
            k += 1
            if k > 24:
                raise UnsupportedStream("mvd escape overflow")
        while k:
            k -= 1
            mvd += eng.bypass() << k
    return -mvd if eng.bypass() else mvd


def _read_dqp(eng: CabacEngine, last_dqp: int) -> int:
    """mb_qp_delta (9.3.2.7 mapping + ctx 60-63)."""
    ctx = 1 if last_dqp else 0
    val = 0
    while eng.decision(60 + ctx):
        ctx = 2 if val == 0 else 3
        val += 1
        if val > 104:
            raise UnsupportedStream("mb_qp_delta runaway")
    return (val + 1) >> 1 if val & 1 else -(val >> 1)


def _intra_mb_type(eng: CabacEngine, base: int, intra_slice: bool,
                   inc0: int) -> int:
    """I-MB mb_type suffix (binarization 9.3.2.5; ffmpeg-equivalent ctx
    walk over the Table 9-39 increments)."""
    if intra_slice:
        if eng.decision(base + inc0) == 0:
            return 0  # I_NxN
        s = base + 2
    else:
        if eng.decision(base) == 0:
            return 0
        s = base
    if eng.terminate():
        return 25  # I_PCM
    mb_type = 1
    mb_type += 12 * eng.decision(s + 1)
    if eng.decision(s + 2):
        mb_type += 4 + 4 * eng.decision(s + 2 + (1 if intra_slice else 0))
    off = 3 + (1 if intra_slice else 0)
    mb_type += 2 * eng.decision(s + off)
    mb_type += eng.decision(s + 3 + (2 if intra_slice else 0))
    return mb_type


_SUB_PARTS_C = {
    0: [(0, 0, 2, 2)],
    1: [(0, 0, 2, 1), (1, 0, 2, 1)],
    2: [(0, 0, 1, 2), (0, 1, 1, 2)],
    3: [(0, 0, 1, 1), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 1, 1)],
}
# _SUB_PARTS entries are (dy, dx, pw, ph) quadruples at 4x4 granularity:
# sub 1 = 8x4 (two rows), sub 2 = 4x8 (two cols), matching h264_dec._SUB_PARTS


def decode_slice_cabac(sd, rbsp: bytes, nal_type: int, state, db,
                       slice_id: int, pic: CabacPictureCtx,
                       ref_idc: int = 1) -> None:
    """Decode one CABAC I or P slice into ``state`` (Y, Cb, Cr int64
    planes), updating the deblock context ``db`` and picture grids
    ``pic``.  ``sd`` is the owning StreamDecoder (sps/pps/DPB access)."""
    from ultragrid_tpu_torch.ops.h264_dec import (BitReader, _parse_dbf,
                                            _parse_pred_weights_l0,
                                            _parse_ref_mod_l0, _weight_pred,
                                            half_planes, pad_ref)

    sps, pps = sd.sps, sd.pps
    r = BitReader(rbsp)
    first_mb = r.ue()
    slice_type = r.ue() % 5
    if slice_type not in (0, 1, 2):
        raise UnsupportedStream(f"CABAC slice type {slice_type}")
    is_p = slice_type == 0
    is_b = slice_type == 1
    r.ue()  # pps id
    fnum = r.u(sps["log2_mfn"])  # frame_num
    sd._cur_frame_num = fnum
    if nal_type == 5:
        r.ue()  # idr_pic_id
    if sps.get("poc_type", 2) == 0:
        sd._cur_poc_lsb = r.u(sps["log2_poc"])
    cur_poc = sd._poc_preview(fnum)
    if is_b:
        if not r.u(1):  # direct_spatial_mv_pred_flag
            raise UnsupportedStream("temporal direct")
        if not sps.get("direct_8x8", 1):
            raise UnsupportedStream("direct_8x8_inference_flag=0")
    l0_active = pps.get("l0_default", 1)
    l1_active = pps.get("l1_default", 1) if is_b else 0
    l0map = list(range(l0_active))
    l1map = []
    wp = wp1 = None
    wbidc = pps.get("weighted_bipred", 0) if is_b else 0
    max_fn = 1 << sps["log2_mfn"]
    if is_p or is_b:
        if r.u(1):  # num_ref_idx_active_override
            l0_active = r.ue() + 1
            if is_b:
                l1_active = r.ue() + 1
        if is_b:
            from ultragrid_tpu_torch.ops.h264_bslice import b_list_init

            i0, i1 = b_list_init(sd.dpb_meta, cur_poc)
            l0map = _parse_ref_mod_l0(r, len(sd.dpb), sd.dpb_meta, fnum,
                                      max_fn, l0_active, init=i0)
            l1map = _parse_ref_mod_l0(r, len(sd.dpb), sd.dpb_meta, fnum,
                                      max_fn, l1_active, init=i1)
            if wbidc == 1:
                wp, wp1 = _parse_pred_weights_l0(r, l0_active, l1_active)
            colmeta = sd.dpb_meta[l1map[0]] if l1map else None
        else:
            l0map = _parse_ref_mod_l0(r, len(sd.dpb), sd.dpb_meta, fnum,
                                      max_fn, l0_active)
            if pps.get("weighted_pred"):
                wp = _parse_pred_weights_l0(r, l0_active)
    # dec_ref_pic_marking (nal_ref_idc != 0 assumed: no-B streams mark
    # every picture as reference)
    if nal_type == 5:
        r.u(1)
        r.u(1)
    elif ref_idc:  # non-ref pictures carry no dec_ref_pic_marking (7.3.3)
        if r.u(1):  # MMCO (8.2.5.4) — op 1 only, applied at DPB insert
            ops = []
            while True:
                op = r.ue()
                if op == 0:
                    break
                if op != 1:
                    raise UnsupportedStream(f"MMCO op {op}")
                ops.append(r.ue() + 1)
            sd._pending_mmco = ops
    cabac_init_idc = r.ue() if (is_p or is_b) else -1
    if not -1 <= cabac_init_idc <= 2:
        raise UnsupportedStream(f"cabac_init_idc {cabac_init_idc}")
    qp = pps["init_qp"] + r.se()
    dbf_idc, dbf_offa, dbf_offb = _parse_dbf(r, pps)
    # cabac_alignment_one_bit
    while r.pos % 8:
        if r.u(1) != 1:
            raise UnsupportedStream("bad cabac alignment bit")
    eng = CabacEngine(rbsp, r.pos,
                      1 + cabac_init_idc if (is_p or is_b) else 0, qp)

    mbw, mbh = sps["mb_w"], sps["mb_h"]
    y, cbp_, crp = state
    if first_mb % mbw:
        raise UnsupportedStream("slices must start at an MB row")
    my0 = first_mb // mbw
    nnz_l = db.nnz if db is not None else np.zeros((mbh * 4, mbw * 4), np.int64)
    nnz_c = [np.zeros((mbh * 2, mbw * 2), np.int64) for _ in range(2)]
    mv4 = db.mvs if db is not None else np.zeros((mbh * 4, mbw * 4, 2), np.int64)
    # ref4 = L0 ref index (MV prediction), picture-wide on sd (colocated
    # motion for B spatial direct); db.refs = picture id (deblock
    # compares reference PICTURES — ref list duplicates alias one picture)
    if sd._pic_ref0 is None:
        sd._pic_ref0 = np.full((mbh * 4, mbw * 4), -1, np.int64)
        sd._pic_ref1 = np.full((mbh * 4, mbw * 4), -1, np.int64)
    ref4 = sd._pic_ref0
    ref4b = sd._pic_ref1
    mv4b = db.mvs1 if db is not None else np.zeros((mbh * 4, mbw * 4, 2), np.int64)
    pid4 = db.refs if db is not None else None
    pid4b = db.refs1 if db is not None else None
    dec4 = np.zeros((mbh * 4, mbw * 4), bool)
    rd4 = np.zeros((mbh * 4, mbw * 4), bool)  # ref_idx known (may precede mv)
    rd4b = np.zeros((mbh * 4, mbw * 4), bool)
    dir4 = np.zeros((mbh * 4, mbw * 4), bool)  # B direct/skip blocks:
    # their derived ref_idx does NOT count toward the ref_idx ctx
    # (9.3.3.1.1.6 — mirrors lavc's direct_cache gating)
    # intra-mode grids (same semantics as the CAVLC paths)
    i4mode = np.full((mbh * 4, mbw * 4), 2, np.int64)
    done4 = np.zeros((mbh * 4, mbw * 4), bool)
    avail4 = np.zeros((mbh * 4, mbw * 4), bool)
    if is_p or is_b:
        done4[: my0 * 4] = True  # P recon does not gate on done4 rows above

    def record(my, mx, *, intra=False, ipcm=False, t8x8=False):
        if db is None:
            return
        db.decoded[my, mx] = True
        db.intra[my, mx] = intra
        db.ipcm[my, mx] = ipcm
        db.qp[my, mx] = qp
        db.slice_id[my, mx] = slice_id
        db.idc[my, mx] = dbf_idc
        db.offa[my, mx] = dbf_offa
        db.offb[my, mx] = dbf_offb
        db.t8x8[my, mx] = t8x8

    # ---- neighbour helpers (availability is slice-gated via my0) --------

    def mb_avail_a(mx):
        return mx > 0

    def mb_avail_b(my):
        return my > my0

    def cbf_inc_mb(grid, mx, my, cur_intra, exists_a, exists_b):
        """ctxIdxInc for MB-granular coded_block_flag (luma/chroma DC)."""
        if mb_avail_a(mx):
            ca = int(grid[my, mx - 1]) if exists_a(my, mx - 1) else 0
            if pic.pcm[my, mx - 1]:
                ca = 1
        else:
            ca = _CBF_UNAVAIL_INTRA if cur_intra else 0
        if mb_avail_b(my):
            cb = int(grid[my - 1, mx]) if exists_b(my - 1, mx) else 0
            if pic.pcm[my - 1, mx]:
                cb = 1
        else:
            cb = _CBF_UNAVAIL_INTRA if cur_intra else 0
        return ca + 2 * cb

    def cbf_inc_blk(grid, gy, gx, gy_min, cur_intra):
        """ctxIdxInc for block-granular coded_block_flag grids (values
        already 0 for uncoded blocks / 1 for PCM)."""
        if gx > 0:
            ca = int(grid[gy, gx - 1])
        else:
            ca = _CBF_UNAVAIL_INTRA if cur_intra else 0
        if gy > gy_min:
            cb = int(grid[gy - 1, gx])
        else:
            cb = _CBF_UNAVAIL_INTRA if cur_intra else 0
        return ca + 2 * cb

    def luma_neighbors(px, py, need_tr):
        gx, gy = px // 4, py // 4
        top = None
        if py > my0 * 16 and done4[gy - 1, gx]:
            t8 = np.empty(8, np.int64)
            t8[:4] = y[py - 1, px:px + 4]
            if need_tr and gx + 1 < mbw * 4 and done4[gy - 1, gx + 1]:
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
        return top, left, tl

    def chroma_pred_block(plane, mx, my, mode):
        x0, y0_ = mx * 8, my * 8
        lcol = plane[y0_:y0_ + 8, x0 - 1].astype(np.int64) if mx > 0 else None
        trow = plane[y0_ - 1, x0:x0 + 8].astype(np.int64) if my > my0 else None
        if mode == 0:
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
        if mode == 1:
            return np.repeat(lcol[:, None], 8, axis=1)
        if mode == 2:
            return np.repeat(trow[None, :], 8, axis=0)
        if mode == 3:
            tl = int(plane[y0_ - 1, x0 - 1])
            return _pred8_chroma_plane(trow, lcol, tl)
        raise UnsupportedStream(f"chroma pred mode {mode}")

    # ---- CABAC syntax element readers ----------------------------------

    def read_chroma_mode(mx, my):
        inc = 0
        if mb_avail_a(mx) and pic.intra[my, mx - 1] and pic.chroma_mode[my, mx - 1]:
            inc += 1
        if mb_avail_b(my) and pic.intra[my - 1, mx] and pic.chroma_mode[my - 1, mx]:
            inc += 1
        if not eng.decision(64 + inc):
            return 0
        if not eng.decision(67):
            return 1
        if not eng.decision(67):
            return 2
        return 3

    def read_cbp(mx, my):
        # luma (9.3.3.1.1.4): cond = 1 iff neighbour 8x8 available with
        # its cbp bit CLEAR (unavailable / PCM count as coded)
        la = int(pic.cbp_l[my, mx - 1]) if mb_avail_a(mx) else -1
        lb = int(pic.cbp_l[my - 1, mx]) if mb_avail_b(my) else -1
        if mb_avail_a(mx) and pic.pcm[my, mx - 1]:
            la = 0xF
        if mb_avail_b(my) and pic.pcm[my - 1, mx]:
            lb = 0xF
        cbp = 0
        ca_ = (1 if not (la & 0x2) else 0) if la >= 0 else _CBP_LUMA_UNAVAIL_A
        cb_ = (1 if not (lb & 0x4) else 0) if lb >= 0 else _CBP_LUMA_UNAVAIL_B
        cbp |= eng.decision(73 + ca_ + 2 * cb_)
        cb_ = (1 if not (lb & 0x8) else 0) if lb >= 0 else _CBP_LUMA_UNAVAIL_B
        cbp |= eng.decision(73 + (1 if not (cbp & 0x1) else 0) + 2 * cb_) << 1
        ca_ = (1 if not (la & 0x8) else 0) if la >= 0 else _CBP_LUMA_UNAVAIL_A
        cbp |= eng.decision(73 + ca_ + 2 * (1 if not (cbp & 0x1) else 0)) << 2
        ctx = (1 if not (cbp & 0x4) else 0) + (2 if not (cbp & 0x2) else 0)
        cbp |= eng.decision(73 + ctx) << 3
        # chroma: bin0 cond = neighbour chroma cbp != 0; bin1 cond == 2
        ca = int(pic.cbp_c[my, mx - 1]) if mb_avail_a(mx) else 0
        cb = int(pic.cbp_c[my - 1, mx]) if mb_avail_b(my) else 0
        if mb_avail_a(mx) and pic.pcm[my, mx - 1]:
            ca = 2
        if mb_avail_b(my) and pic.pcm[my - 1, mx]:
            cb = 2
        cc = 0
        if eng.decision(77 + (1 if ca else 0) + (2 if cb else 0)):
            cc = 1 + eng.decision(81 + (1 if ca == 2 else 0)
                                  + (2 if cb == 2 else 0))
        return cbp, cc

    def read_ref_idx(gy, gx, pw=4, ph=4, lst=0):
        act = l1_active if lst else l0_active
        rg = ref4b if lst else ref4
        rdg = rd4b if lst else rd4
        if act <= 1:
            return 0
        ca = 1 if (gx > 0 and rdg[gy, gx - 1] and rg[gy, gx - 1] > 0
                   and not dir4[gy, gx - 1]) else 0
        cb = 1 if (gy > my0 * 4 and rdg[gy - 1, gx]
                   and rg[gy - 1, gx] > 0 and not dir4[gy - 1, gx]) else 0
        if not eng.decision(54 + ca + 2 * cb):
            return 0
        if not eng.decision(58):
            return 1
        ref = 2
        while eng.decision(59):
            ref += 1
            if ref > 32:
                raise UnsupportedStream("ref_idx runaway")
        if ref >= act:
            raise UnsupportedStream(f"ref_idx {ref}")
        return ref

    def note_ref(gy, gx, pw, ph, ri, lst=0):
        """Record a just-read ref_idx so later same-MB partitions derive
        their ref_idx ctx from it (syntax order reads ALL ref_idx before
        any mvd, so the mv fill has not happened yet)."""
        rg = ref4b if lst else ref4
        rdg = rd4b if lst else rd4
        rg[gy:gy + ph, gx:gx + pw] = ri
        rdg[gy:gy + ph, gx:gx + pw] = True
        return ri

    def read_t8_flag(mx, my):
        # transform_size_8x8_flag (9.3.3.1.1.10): ctx 399 + condA + condB
        inc = 0
        if mb_avail_a(mx) and pic.t8x8[my, mx - 1]:
            inc += 1
        if mb_avail_b(my) and pic.t8x8[my - 1, mx]:
            inc += 1
        return eng.decision(399 + inc) == 1

    def decode_luma8x8_cabac(mx, my, cbp_luma_mb, qp_):
        """The four 8x8 luma residual blocks (cat 5) -> 16x16 spatial
        residual; updates the cbf grid (cells carry the CBP bit, which is
        the 8x8 coded_block_flag neighbours see per 9.3.3.1.1.9) and the
        per-4x4 nnz grid (interleaved sub-block counts, the deblock OR
        happens per containing 8x8)."""
        from ultragrid_tpu_torch.ops.h264_8x8 import recon_res8

        luma_res = np.zeros((16, 16), np.int64)
        for b in range(4):
            has = bool(cbp_luma_mb & (1 << b))
            zz = _residual_cabac8(eng) if has else None
            for k in range(4):
                bx, by = H._BLK_ORDER[b * 4 + k]
                gx, gy = mx * 4 + bx, my * 4 + by
                pic.cbf_l4[gy, gx] = 1 if has else 0
                nnz_l[gy, gx] = (int(np.count_nonzero(zz[k::4]))
                                 if zz is not None else 0)
            if zz is not None:
                py8, px8 = (b // 2) * 8, (b % 2) * 8
                luma_res[py8:py8 + 8, px8:px8 + 8] = recon_res8(zz, qp_)
        return luma_res

    def read_mvd_pair(gy, gx, lst=0):
        am = pic.absmvd4b if lst else pic.absmvd4
        ax = ay = 0
        if gx > 0 and dec4[gy, gx - 1]:
            ax += int(am[gy, gx - 1, 0])
            ay += int(am[gy, gx - 1, 1])
        if gy > my0 * 4 and dec4[gy - 1, gx]:
            ax += int(am[gy - 1, gx, 0])
            ay += int(am[gy - 1, gx, 1])
        mdx = _read_mvd(eng, 40, ax)
        mdy = _read_mvd(eng, 47, ay)
        return mdx, mdy

    def residual_l4(cat, gy, gx, has, vy, qp_):
        """Luma 4x4 (cat 2) / AC (cat 1) residual -> spatial residual."""
        n = 15 if cat == 1 else 16
        if not has:
            pic.cbf_l4[gy, gx] = 0
            nnz_l[gy, gx] = 0
            return np.zeros((4, 4), np.int64)
        inc = cbf_inc_blk(pic.cbf_l4, gy, gx, my0 * 4, cur_intra)
        zz = _residual_cabac(eng, cat, n, inc)
        if zz is None:
            pic.cbf_l4[gy, gx] = 0
            nnz_l[gy, gx] = 0
            return np.zeros((4, 4), np.int64)
        pic.cbf_l4[gy, gx] = 1
        nnz_l[gy, gx] = int(np.count_nonzero(zz))
        full = np.zeros(16, np.int64)
        full[16 - n:] = zz
        d = _dezigzag(full) * vy << (qp_ // 6)
        return d  # caller finishes (DC substitution for I16)

    # ---- per-MB decoders ------------------------------------------------

    def clear_mb_ctx(mx, my, *, intra, skip=False, ipcm=False):
        pic.skip[my, mx] = skip
        pic.intra[my, mx] = intra
        pic.pcm[my, mx] = ipcm
        pic.i16[my, mx] = ipcm
        pic.chroma_mode[my, mx] = 0
        pic.cbp_l[my, mx] = 0
        pic.cbp_c[my, mx] = 0
        pic.cbf_ldc[my, mx] = 0
        pic.cbf_l4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        pic.cbf_cdc[:, my, mx] = 0
        pic.cbf_c4[:, my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
        pic.absmvd4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        pic.absmvd4b[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        pic.bdirect[my, mx] = False
        pic.t8x8[my, mx] = False

    def chroma_residuals_cabac(cbp_chroma, mx, my, vc, qpc):
        cdc = [np.zeros(4, np.int64), np.zeros(4, np.int64)]
        cac = [np.zeros((2, 2, 16), np.int64) for _ in range(2)]
        if cbp_chroma:
            for ci in range(2):
                inc = cbf_inc_mb(
                    pic.cbf_cdc[ci], mx, my, cur_intra,
                    lambda yy, xx: pic.cbp_c[yy, xx] > 0,
                    lambda yy, xx: pic.cbp_c[yy, xx] > 0)
                zz = _residual_cabac(eng, 3, 4, inc)
                if zz is not None:
                    cdc[ci][:] = zz
                    pic.cbf_cdc[ci, my, mx] = 1
        if cbp_chroma == 2:
            for ci in range(2):
                for bx, by in ((0, 0), (1, 0), (0, 1), (1, 1)):
                    gx, gy = mx * 2 + bx, my * 2 + by
                    inc = cbf_inc_blk(pic.cbf_c4[ci], gy, gx, my0 * 2,
                                      cur_intra)
                    zz = _residual_cabac(eng, 4, 15, inc)
                    if zz is not None:
                        cac[ci][by, bx, 1:] = zz
                        pic.cbf_c4[ci, gy, gx] = 1
                        nnz_c[ci][gy, gx] = int(np.count_nonzero(zz))
                    else:
                        nnz_c[ci][gy, gx] = 0
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

    def decode_intra_mb(mx, my, mb_type):
        nonlocal qp, last_dqp
        qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
        if mb_type == 25:  # I_PCM
            # pcm_alignment + samples ride the bypass engine "decoded as
            # fixed-length via DecodeBypass"?  Spec 9.3.1/7.3.5: after the
            # pcm_alignment_zero_bit the samples are read as raw bytes and
            # the engine is re-initialized (9.3.1.2).
            # eng.pos points at the next bit AFTER the last consumed one;
            # offset holds 9 look-ahead bits + renorm bits.  Per spec the
            # decoder re-aligns: sample reading starts at the bitstream
            # position backed up by the unused offset bits.
            raise UnsupportedStream("I_PCM in CABAC stream")
        i4mode_mb = None
        if mb_type == 0 and pps.get("transform_8x8") and read_t8_flag(mx, my):
            # ---- Intra_8x8 (High profile) ----
            from ultragrid_tpu_torch.ops.h264_8x8 import filter_refs8, pred8x8
            from ultragrid_tpu_torch.ops.h264_dec import luma_neighbors8

            modes8 = []
            for b in range(4):
                gx = mx * 4 + (b % 2) * 2
                gy = my * 4 + (b // 2) * 2
                ma = i4mode[gy, gx - 1] if gx > 0 and avail4[gy, gx - 1] else -1
                mb_ = i4mode[gy - 1, gx] if gy > my0 * 4 and avail4[gy - 1, gx] else -1
                pm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
                if ma < 0 or mb_ < 0:
                    pm = 2
                if eng.decision(68):
                    m = pm
                else:
                    rem = eng.decision(69)
                    rem += 2 * eng.decision(69)
                    rem += 4 * eng.decision(69)
                    m = rem if rem < pm else rem + 1
                modes8.append(m)
                i4mode[gy:gy + 2, gx:gx + 2] = m
                avail4[gy:gy + 2, gx:gx + 2] = True
            chroma_mode = read_chroma_mode(mx, my)
            cbp_luma_mb, cbp_chroma = read_cbp(mx, my)
            pic.intra[my, mx] = True
            pic.i16[my, mx] = False
            pic.t8x8[my, mx] = True
            pic.chroma_mode[my, mx] = chroma_mode
            pic.cbp_l[my, mx] = cbp_luma_mb
            pic.cbp_c[my, mx] = cbp_chroma
            if cbp_luma_mb or cbp_chroma:
                dqp = _read_dqp(eng, last_dqp)
                last_dqp = dqp
                qp = qp + dqp
            else:
                last_dqp = 0
            qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
            vc = _vmat(qpc)
            luma_res = decode_luma8x8_cabac(mx, my, cbp_luma_mb, qp)
            for b in range(4):
                gx = mx * 4 + (b % 2) * 2
                gy = my * 4 + (b // 2) * 2
                px, py = gx * 4, gy * 4
                top, left, tl = luma_neighbors8(y, done4, mbw, my0, px, py)
                ft, fl, ftl = filter_refs8(top, left, tl)
                pred = pred8x8(int(modes8[b]), ft, fl, ftl)
                py8, px8 = (b // 2) * 8, (b % 2) * 8
                y[py:py + 8, px:px + 8] = np.clip(
                    pred + luma_res[py8:py8 + 8, px8:px8 + 8], 0, 255)
                done4[gy:gy + 2, gx:gx + 2] = True
            cres = chroma_residuals_cabac(cbp_chroma, mx, my, vc, qpc)
            for ci, plane in enumerate((cbp_, crp)):
                predc = chroma_pred_block(plane, mx, my, chroma_mode)
                plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(
                    predc + cres[ci], 0, 255)
            record(my, mx, intra=True, t8x8=True)
            return
        if mb_type == 0:
            modes = np.zeros(16, np.int64)
            for bi, (bx, by) in enumerate(H._BLK_ORDER):
                gx, gy = mx * 4 + bx, my * 4 + by
                ma = i4mode[gy, gx - 1] if gx > 0 and avail4[gy, gx - 1] else -1
                mb_ = i4mode[gy - 1, gx] if gy > my0 * 4 and avail4[gy - 1, gx] else -1
                pm = min(ma if ma >= 0 else 2, mb_ if mb_ >= 0 else 2)
                if ma < 0 or mb_ < 0:
                    pm = 2
                if eng.decision(68):
                    modes[bi] = pm
                else:
                    rem = eng.decision(69)
                    rem += 2 * eng.decision(69)
                    rem += 4 * eng.decision(69)
                    modes[bi] = rem if rem < pm else rem + 1
                i4mode[gy, gx] = modes[bi]
                avail4[gy, gx] = True
            i4mode_mb = modes
            chroma_mode = read_chroma_mode(mx, my)
            cbp_luma_mb, cbp_chroma = read_cbp(mx, my)
        else:
            t = mb_type - 1
            pred_mode16 = t % 4
            cbp_chroma = (t // 4) % 3
            cbp_luma_mb = 15 if t >= 12 else 0
            chroma_mode = read_chroma_mode(mx, my)
            i4mode[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 2
            avail4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
        pic.intra[my, mx] = True
        pic.i16[my, mx] = mb_type != 0
        pic.chroma_mode[my, mx] = chroma_mode
        pic.cbp_l[my, mx] = cbp_luma_mb
        pic.cbp_c[my, mx] = cbp_chroma

        if mb_type == 0:
            if cbp_luma_mb or cbp_chroma:
                dqp = _read_dqp(eng, last_dqp)
                last_dqp = dqp
                qp = qp + dqp
            else:
                last_dqp = 0
            qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
            vy, vc = _vmat(qp), _vmat(qpc)
            for bi, (bx, by) in enumerate(H._BLK_ORDER):
                gx, gy = mx * 4 + bx, my * 4 + by
                px, py = gx * 4, gy * 4
                mode = int(i4mode_mb[bi])
                need_tr = mode in (3, 7)
                top, left, tl = luma_neighbors(px, py, need_tr)
                pred = _pred4x4(mode, top, left, tl)
                has = bool(cbp_luma_mb & (1 << (bi // 4)))
                d = residual_l4(2, gy, gx, has, vy, qp)
                if d.shape == (4, 4) and not has:
                    res = d
                elif not pic.cbf_l4[gy, gx]:
                    res = np.zeros((4, 4), np.int64)
                else:
                    res = (_itransform4(d) + 32) >> 6
                y[py:py + 4, px:px + 4] = np.clip(pred + res, 0, 255)
                done4[gy, gx] = True
            cres = chroma_residuals_cabac(cbp_chroma, mx, my, vc, qpc)
            for ci, plane in enumerate((cbp_, crp)):
                predc = chroma_pred_block(plane, mx, my, chroma_mode)
                plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(
                    predc + cres[ci], 0, 255)
            record(my, mx, intra=True)
            return

        # ---- I_16x16 ----
        dqp = _read_dqp(eng, last_dqp)
        last_dqp = dqp
        qp = qp + dqp
        qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
        vy, vc = _vmat(qp), _vmat(qpc)
        inc = cbf_inc_mb(pic.cbf_ldc, mx, my, True,
                         lambda yy, xx: pic.i16[yy, xx],
                         lambda yy, xx: pic.i16[yy, xx])
        dc_zz16 = _residual_cabac(eng, 0, 16, inc)
        if dc_zz16 is None:
            dc_zz16 = np.zeros(16, np.int64)
        else:
            pic.cbf_ldc[my, mx] = 1
        ac = np.zeros((4, 4, 16), np.int64)
        if cbp_luma_mb:
            for bx, by in H._BLK_ORDER:
                gx, gy = mx * 4 + bx, my * 4 + by
                inc = cbf_inc_blk(pic.cbf_l4, gy, gx, my0 * 4, True)
                zz = _residual_cabac(eng, 1, 15, inc)
                if zz is not None:
                    ac[by, bx, 1:] = zz
                    pic.cbf_l4[gy, gx] = 1
                    nnz_l[gy, gx] = int(np.count_nonzero(zz))
                else:
                    nnz_l[gy, gx] = 0
        else:
            nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0

        left = y[my * 16:my * 16 + 16, mx * 16 - 1] if mx > 0 else None
        top = y[my * 16 - 1, mx * 16:mx * 16 + 16] if my > my0 else None
        if pred_mode16 == 0:
            pred16 = np.repeat(top[None, :].astype(np.int64), 16, axis=0)
        elif pred_mode16 == 1:
            pred16 = np.repeat(left[:, None].astype(np.int64), 16, axis=1)
        elif pred_mode16 == 2:
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
        f = _ihadamard4(_dezigzag(dc_zz16))
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
                blk = np.clip(
                    pred16[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + res, 0, 255)
                y[my * 16 + by * 4:my * 16 + by * 4 + 4,
                  mx * 16 + bx * 4:mx * 16 + bx * 4 + 4] = blk
        done4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
        cres = chroma_residuals_cabac(cbp_chroma, mx, my, vc, qpc)
        for ci, plane in enumerate((cbp_, crp)):
            predc = chroma_pred_block(plane, mx, my, chroma_mode)
            plane[my * 8:my * 8 + 8, mx * 8:mx * 8 + 8] = np.clip(
                predc + cres[ci], 0, 255)
        record(my, mx, intra=True)

    # ---- P machinery (mirrors _decode_slice_p) --------------------------

    pads = sd._dpb_pad

    def refp(di):
        if pads[di] is None:
            pads[di] = [tuple(pad_ref(p) for p in sd.dpb[di]), None]
        return pads[di]

    def get_halfp(di):
        ent = refp(di)
        if ent[1] is None:
            ent[1] = half_planes(ent[0][0])
        return ent[1]

    def part_pred(pred16, predc, mx, my, gy, gx, pw, ph, mvx, mvy, ri):
        di = l0map[ri]
        ry, rcb, rcr = refp(di)[0]
        hp = get_halfp(di) if ((mvx | mvy) & 3) else None
        ly, lx = (gy - my * 4) * 4, (gx - mx * 4) * 4
        mc = mc_luma(ry, gx * 4, gy * 4, mvx, mvy, w=pw * 4, h=ph * 4,
                     halfp=hp)
        if wp is not None:
            w_, o_ = wp["luma"][ri]
            mc = _weight_pred(mc, w_, o_, wp["ld"])
        pred16[ly:ly + ph * 4, lx:lx + pw * 4] = mc
        cy2, cx2 = ly // 2, lx // 2
        for ci, refc in ((0, rcb), (1, rcr)):
            mcc = mc_chroma(refc, gx * 2, gy * 2, mvx, mvy,
                            w=pw * 2, h=ph * 2)
            if wp is not None:
                w_, o_ = wp["chroma"][ri][ci]
                mcc = _weight_pred(mcc, w_, o_, wp["cd"])
            predc[ci][cy2:cy2 + ph * 2, cx2:cx2 + pw * 2] = mcc

    def fill4(gy, gx, pw, ph, mvx, mvy, ri, amx=0, amy=0):
        mv4[gy:gy + ph, gx:gx + pw] = (mvx, mvy)
        ref4[gy:gy + ph, gx:gx + pw] = ri
        if pid4 is not None:
            pid4[gy:gy + ph, gx:gx + pw] = sd.dpb_meta[l0map[ri]]["pid"]
        dec4[gy:gy + ph, gx:gx + pw] = True
        rd4[gy:gy + ph, gx:gx + pw] = True
        pic.absmvd4[gy:gy + ph, gx:gx + pw] = (amx, amy)

    def recon_mb(mx, my, pred16, predc, luma_res, chroma_res):
        px, py = mx * 16, my * 16
        y[py:py + 16, px:px + 16] = np.clip(pred16 + luma_res, 0, 255)
        cx, cy = mx * 8, my * 8
        for ci, plane in enumerate((cbp_, crp)):
            plane[cy:cy + 8, cx:cx + 8] = np.clip(
                predc[ci] + chroma_res[ci], 0, 255)

    zero16 = np.zeros((16, 16), np.int64)
    zero8 = [np.zeros((8, 8), np.int64), np.zeros((8, 8), np.int64)]

    def decode_p_skip(mx, my):
        mvx, mvy = skip_mv4(mv4, ref4, dec4, mx, my, my0, mbw)
        pred16 = np.zeros((16, 16), np.int64)
        predc = [np.zeros((8, 8), np.int64) for _ in range(2)]
        part_pred(pred16, predc, mx, my, my * 4, mx * 4, 4, 4, mvx, mvy, 0)
        recon_mb(mx, my, pred16, predc, zero16, zero8)
        fill4(my * 4, mx * 4, 4, 4, mvx, mvy, 0)
        nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        done4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
        i4mode[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 2
        avail4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
        record(my, mx)

    def decode_p_mb(mx, my, mb_type):
        nonlocal qp, last_dqp
        subs = [0, 0, 0, 0]
        gy0, gx0 = my * 4, mx * 4
        pred16 = np.zeros((16, 16), np.int64)
        predc = [np.zeros((8, 8), np.int64) for _ in range(2)]
        i4mode[gy0:gy0 + 4, gx0:gx0 + 4] = 2
        avail4[gy0:gy0 + 4, gx0:gx0 + 4] = True
        if mb_type == 0:  # P_L0_16x16
            ri = note_ref(gy0, gx0, 4, 4, read_ref_idx(gy0, gx0))
            mdx, mdy = read_mvd_pair(gy0, gx0)
            pmx, pmy = mv_pred4(mv4, ref4, dec4, gy0, gx0, 4, ri, my0, mbw)
            mvx, mvy = pmx + mdx, pmy + mdy
            part_pred(pred16, predc, mx, my, gy0, gx0, 4, 4, mvx, mvy, ri)
            fill4(gy0, gx0, 4, 4, mvx, mvy, ri, abs(mdx), abs(mdy))
        elif mb_type in (1, 2):
            if mb_type == 1:
                geo = [(gy0, gx0, 4, 2, "16x8_0"), (gy0 + 2, gx0, 4, 2, "16x8_1")]
            else:
                geo = [(gy0, gx0, 2, 4, "8x16_0"), (gy0, gx0 + 2, 2, 4, "8x16_1")]
            ris = [note_ref(gy, gx, pw, ph, read_ref_idx(gy, gx))
                   for (gy, gx, pw, ph, _) in geo]
            for (gy, gx, pw, ph, shape), ri in zip(geo, ris):
                mdx, mdy = read_mvd_pair(gy, gx)
                pmx, pmy = mv_pred4(mv4, ref4, dec4, gy, gx, pw, ri,
                                    my0, mbw, shape)
                mvx, mvy = pmx + mdx, pmy + mdy
                part_pred(pred16, predc, mx, my, gy, gx, pw, ph, mvx, mvy, ri)
                fill4(gy, gx, pw, ph, mvx, mvy, ri, abs(mdx), abs(mdy))
        else:  # P_8x8
            subs.clear()
            for _ in range(4):
                if eng.decision(21):
                    subs.append(0)
                elif not eng.decision(22):
                    subs.append(1)
                elif eng.decision(23):
                    subs.append(2)
                else:
                    subs.append(3)
            ris = [note_ref(gy0 + (b // 2) * 2, gx0 + (b % 2) * 2, 2, 2,
                            read_ref_idx(gy0 + (b // 2) * 2,
                                         gx0 + (b % 2) * 2))
                   for b in range(4)]
            from ultragrid_tpu_torch.ops.h264_dec import _SUB_PARTS

            for b in range(4):
                by, bx = gy0 + (b // 2) * 2, gx0 + (b % 2) * 2
                for dy, dx, pw, ph in _SUB_PARTS[subs[b]]:
                    gy, gx = by + dy, bx + dx
                    mdx, mdy = read_mvd_pair(gy, gx)
                    pmx, pmy = mv_pred4(mv4, ref4, dec4, gy, gx, pw,
                                        ris[b], my0, mbw)
                    mvx, mvy = pmx + mdx, pmy + mdy
                    part_pred(pred16, predc, mx, my, gy, gx, pw, ph,
                              mvx, mvy, ris[b])
                    fill4(gy, gx, pw, ph, mvx, mvy, ris[b],
                          abs(mdx), abs(mdy))
        inter_tail(mx, my, pred16, predc,
                   not (mb_type <= 2 or all(s == 0 for s in subs)))

    def inter_tail(mx, my, pred16, predc, small_parts):
        """cbp -> transform_size_8x8_flag -> dqp -> residuals -> recon,
        shared by P and B inter MBs."""
        nonlocal qp, last_dqp
        gy0, gx0 = my * 4, mx * 4
        cbp_luma_mb, cbp_chroma = read_cbp(mx, my)
        pic.cbp_l[my, mx] = cbp_luma_mb
        pic.cbp_c[my, mx] = cbp_chroma
        t8 = False
        if (cbp_luma_mb and pps.get("transform_8x8") and not small_parts):
            t8 = read_t8_flag(mx, my)
            pic.t8x8[my, mx] = t8
        qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
        vy, vc = _vmat(qp), _vmat(qpc)
        luma_res = np.zeros((16, 16), np.int64)
        cres = zero8
        if cbp_luma_mb or cbp_chroma:
            dqp = _read_dqp(eng, last_dqp)
            last_dqp = dqp
            qp = qp + dqp
            qpc = H.chroma_qp(max(0, min(51, qp + pps["chroma_off"])))
            vy, vc = _vmat(qp), _vmat(qpc)
            if t8:
                luma_res = decode_luma8x8_cabac(mx, my, cbp_luma_mb, qp)
            else:
                for bi, (bx, by) in enumerate(H._BLK_ORDER):
                    gx, gy = mx * 4 + bx, my * 4 + by
                    has = bool(cbp_luma_mb & (1 << (bi // 4)))
                    d = residual_l4(2, gy, gx, has, vy, qp)
                    if pic.cbf_l4[gy, gx]:
                        luma_res[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] = (
                            (_itransform4(d) + 32) >> 6)
            cres = chroma_residuals_cabac(cbp_chroma, mx, my, vc, qpc)
        else:
            last_dqp = 0
            nnz_l[gy0:gy0 + 4, gx0:gx0 + 4] = 0
            for nn in nnz_c:
                nn[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
        recon_mb(mx, my, pred16, predc, luma_res, cres)
        done4[gy0:gy0 + 4, gx0:gx0 + 4] = True
        record(my, mx, t8x8=t8)


    # ---- B machinery (mirrors _decode_slice_p's B paths) ----------------

    def part_pred_b(pred16, predc, mx, my, gy, gx, pw, ph,
                    mv0, mv1, ri0, ri1):
        from ultragrid_tpu_torch.ops.h264_bslice import implicit_weights

        ly, lx = (gy - my * 4) * 4, (gx - mx * 4) * 4
        cy2, cx2 = ly // 2, lx // 2

        def one(lmap, ri, mv, wpt):
            di = lmap[ri]
            ry, rcb, rcr = refp(di)[0]
            hp = get_halfp(di) if ((mv[0] | mv[1]) & 3) else None
            mc = mc_luma(ry, gx * 4, gy * 4, mv[0], mv[1], w=pw * 4,
                         h=ph * 4, halfp=hp)
            cs = []
            for ci, refc in ((0, rcb), (1, rcr)):
                cs.append(mc_chroma(refc, gx * 2, gy * 2, mv[0], mv[1],
                                    w=pw * 2, h=ph * 2))
            if wpt is not None:
                from ultragrid_tpu_torch.ops.h264_dec import _weight_pred
                w_, o_ = wpt["luma"][ri]
                mc = _weight_pred(mc, w_, o_, wpt["ld"])
                for ci in range(2):
                    w_, o_ = wpt["chroma"][ri][ci]
                    cs[ci] = _weight_pred(cs[ci], w_, o_, wpt["cd"])
            return mc, cs

        if ri1 < 0:
            mc, cs = one(l0map, ri0, mv0, wp)
        elif ri0 < 0:
            mc, cs = one(l1map, ri1, mv1, wp1)
        else:
            m0, c0 = one(l0map, ri0, mv0, None)
            m1, c1 = one(l1map, ri1, mv1, None)
            if wbidc == 2:
                p0 = sd.dpb_meta[l0map[ri0]]["poc"]
                p1 = sd.dpb_meta[l1map[ri1]]["poc"]
                w0, w1 = implicit_weights(cur_poc, p0, p1)
                mc = np.clip((m0 * w0 + m1 * w1 + 32) >> 6, 0, 255)
                cs = [np.clip((c0[ci] * w0 + c1[ci] * w1 + 32) >> 6, 0, 255)
                      for ci in range(2)]
            elif wbidc == 1:
                ld = wp["ld"]
                wl0, ol0 = wp["luma"][ri0]
                wl1, ol1 = wp1["luma"][ri1]
                mc = np.clip(((m0 * wl0 + m1 * wl1 + (1 << ld)) >> (ld + 1))
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

    def fill_list(gy, gx, pw, ph, mv, ri, amx, amy, lst, direct=False):
        """One list's motion grids for a partition (-1 ri = unused)."""
        dir4[gy:gy + ph, gx:gx + pw] = direct
        if lst == 0:
            mv4[gy:gy + ph, gx:gx + pw] = mv if ri >= 0 else (0, 0)
            ref4[gy:gy + ph, gx:gx + pw] = ri
            rd4[gy:gy + ph, gx:gx + pw] = True
            pic.absmvd4[gy:gy + ph, gx:gx + pw] = (amx, amy)
            if pid4 is not None:
                pid4[gy:gy + ph, gx:gx + pw] = (
                    sd.dpb_meta[l0map[ri]]["pid"] if ri >= 0 else -1)
        else:
            mv4b[gy:gy + ph, gx:gx + pw] = mv if ri >= 0 else (0, 0)
            ref4b[gy:gy + ph, gx:gx + pw] = ri
            rd4b[gy:gy + ph, gx:gx + pw] = True
            pic.absmvd4b[gy:gy + ph, gx:gx + pw] = (amx, amy)
            if pid4b is not None:
                pid4b[gy:gy + ph, gx:gx + pw] = (
                    sd.dpb_meta[l1map[ri]]["pid"] if ri >= 0 else -1)
        dec4[gy:gy + ph, gx:gx + pw] = True

    def direct_block_cab(mx, my):
        """B_Skip / B_Direct_16x16 (spatial, 8x8 inference)."""
        from ultragrid_tpu_torch.ops.h264_bslice import (col_zero, direct_corner,
                                                   direct_ref_indices)

        gy0, gx0 = my * 4, mx * 4
        ri0, ri1 = direct_ref_indices(ref4, ref4b, gy0, gx0, my0, mbw, dec4)
        zero_pred = ri0 < 0 and ri1 < 0
        if zero_pred:
            ri0 = ri1 = 0
            mvp0 = mvp1 = (0, 0)
        else:
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
            m0 = (0, 0) if zero_pred or (cz and ri0 == 0) else mvp0
            m1 = (0, 0) if zero_pred or (cz and ri1 == 0) else mvp1
            part_pred_b(pred16, predc, mx, my, qy, qx, 2, 2,
                        m0, m1, ri0, ri1)
            fill_list(qy, qx, 2, 2, m0, ri0, 0, 0, 0, direct=True)
            fill_list(qy, qx, 2, 2, m1, ri1, 0, 0, 1, direct=True)
        return pred16, predc

    def read_b_mb_type(mx, my):
        """B mb_type binarization (Table 9-37, ctx 27..31); returns the
        Table 7-14 value, or 23 + intra subtype for the intra escape."""
        inc = 0
        if mb_avail_a(mx) and not pic.bdirect[my, mx - 1]:
            inc += 1
        if mb_avail_b(my) and not pic.bdirect[my - 1, mx]:
            inc += 1
        if not eng.decision(27 + inc):
            return 0  # B_Direct_16x16
        if not eng.decision(27 + 3):
            return 1 + eng.decision(27 + 5)
        bits = eng.decision(27 + 4) << 3
        bits |= eng.decision(27 + 5) << 2
        bits |= eng.decision(27 + 5) << 1
        bits |= eng.decision(27 + 5)
        if bits < 8:
            return bits + 3
        if bits == 13:
            return 23 + _intra_mb_type(eng, 32, False, 0)
        if bits == 14:
            return 11
        if bits == 15:
            return 22
        bits = (bits << 1) | eng.decision(27 + 5)
        return bits - 4

    def read_b_sub_type():
        """B sub_mb_type binarization (Table 9-38, ctx 36..39)."""
        if not eng.decision(36):
            return 0  # B_Direct_8x8
        if not eng.decision(37):
            return 1 + eng.decision(39)
        t = 3
        if eng.decision(38):
            if eng.decision(39):
                return 11 + eng.decision(39)
            t += 4
        t += 2 * eng.decision(39)
        t += eng.decision(39)
        return t

    def decode_b_skip(mx, my):
        pred16, predc = direct_block_cab(mx, my)
        recon_mb(mx, my, pred16, predc, zero16, zero8)
        nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
        done4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
        i4mode[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 2
        avail4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
        record(my, mx)

    def decode_b_mb(mx, my, mb_type):
        from ultragrid_tpu_torch.ops.h264_dec import _B_PAIR, _B_SUB, _SUB_PARTS
        from ultragrid_tpu_torch.ops.h264_bslice import (col_zero, direct_corner,
                                                   direct_ref_indices)

        gy0, gx0 = my * 4, mx * 4
        i4mode[gy0:gy0 + 4, gx0:gx0 + 4] = 2
        avail4[gy0:gy0 + 4, gx0:gx0 + 4] = True
        if mb_type == 0:
            pred16, predc = direct_block_cab(mx, my)
            inter_tail(mx, my, pred16, predc, False)
            return
        pred16 = np.zeros((16, 16), np.int64)
        predc = [np.zeros((8, 8), np.int64) for _ in range(2)]
        if mb_type <= 3:  # 16x16: 1 L0, 2 L1, 3 Bi
            use0 = mb_type in (1, 3)
            use1 = mb_type in (2, 3)
            ri0 = note_ref(gy0, gx0, 4, 4,
                           read_ref_idx(gy0, gx0), 0) if use0 else -1
            ri1 = note_ref(gy0, gx0, 4, 4,
                           read_ref_idx(gy0, gx0, lst=1), 1) if use1 else -1
            mv0 = mv1 = (0, 0)
            if use0:
                mdx, mdy = read_mvd_pair(gy0, gx0, 0)
                pmx, pmy = mv_pred4(mv4, ref4, dec4, gy0, gx0, 4, ri0,
                                    my0, mbw)
                mv0 = (pmx + mdx, pmy + mdy)
                fill_list(gy0, gx0, 4, 4, mv0, ri0, abs(mdx), abs(mdy), 0)
            else:
                fill_list(gy0, gx0, 4, 4, (0, 0), -1, 0, 0, 0)
            if use1:
                mdx, mdy = read_mvd_pair(gy0, gx0, 1)
                pmx, pmy = mv_pred4(mv4b, ref4b, dec4, gy0, gx0, 4, ri1,
                                    my0, mbw)
                mv1 = (pmx + mdx, pmy + mdy)
                fill_list(gy0, gx0, 4, 4, mv1, ri1, abs(mdx), abs(mdy), 1)
            else:
                fill_list(gy0, gx0, 4, 4, (0, 0), -1, 0, 0, 1)
            part_pred_b(pred16, predc, mx, my, gy0, gx0, 4, 4,
                        mv0, mv1, ri0, ri1)
            inter_tail(mx, my, pred16, predc, False)
            return
        if mb_type <= 21:  # two-partition types
            pair = _B_PAIR[(mb_type - 4) // 2]
            if (mb_type - 4) % 2 == 0:
                geo = [(gy0, gx0, 4, 2, "16x8_0"),
                       (gy0 + 2, gx0, 4, 2, "16x8_1")]
            else:
                geo = [(gy0, gx0, 2, 4, "8x16_0"),
                       (gy0, gx0 + 2, 2, 4, "8x16_1")]
            use0 = [pair[p] in (0, 2) for p in range(2)]
            use1 = [pair[p] in (1, 2) for p in range(2)]
            ri0 = [note_ref(g[0], g[1], g[2], g[3],
                            read_ref_idx(g[0], g[1]), 0)
                   if use0[p] else -1 for p, g in enumerate(geo)]
            ri1 = [note_ref(g[0], g[1], g[2], g[3],
                            read_ref_idx(g[0], g[1], lst=1), 1)
                   if use1[p] else -1 for p, g in enumerate(geo)]
            mvs0 = [(0, 0), (0, 0)]
            mvs1 = [(0, 0), (0, 0)]
            for p, (gy, gx, pw, ph, shape) in enumerate(geo):
                if use0[p]:
                    mdx, mdy = read_mvd_pair(gy, gx, 0)
                    pmx, pmy = mv_pred4(mv4, ref4, dec4, gy, gx, pw,
                                        ri0[p], my0, mbw, shape)
                    mvs0[p] = (pmx + mdx, pmy + mdy)
                    fill_list(gy, gx, pw, ph, mvs0[p], ri0[p],
                              abs(mdx), abs(mdy), 0)
                else:
                    fill_list(gy, gx, pw, ph, (0, 0), -1, 0, 0, 0)
            for p, (gy, gx, pw, ph, shape) in enumerate(geo):
                if use1[p]:
                    mdx, mdy = read_mvd_pair(gy, gx, 1)
                    pmx, pmy = mv_pred4(mv4b, ref4b, dec4, gy, gx, pw,
                                        ri1[p], my0, mbw, shape)
                    mvs1[p] = (pmx + mdx, pmy + mdy)
                    fill_list(gy, gx, pw, ph, mvs1[p], ri1[p],
                              abs(mdx), abs(mdy), 1)
                else:
                    fill_list(gy, gx, pw, ph, (0, 0), -1, 0, 0, 1)
            for p, (gy, gx, pw, ph, _) in enumerate(geo):
                part_pred_b(pred16, predc, mx, my, gy, gx, pw, ph,
                            mvs0[p], mvs1[p], ri0[p], ri1[p])
            inter_tail(mx, my, pred16, predc, False)
            return
        if mb_type != 22:
            raise UnsupportedStream(f"B mb_type {mb_type}")
        subs = [read_b_sub_type() for _ in range(4)]
        su0 = [_B_SUB[t][1] in (0, 2) if t else False for t in subs]
        su1 = [_B_SUB[t][1] in (1, 2) if t else False for t in subs]
        bpos = [(gy0 + (b // 2) * 2, gx0 + (b % 2) * 2) for b in range(4)]
        ri0 = [note_ref(bpos[b][0], bpos[b][1], 2, 2,
                        read_ref_idx(bpos[b][0], bpos[b][1]), 0)
               if su0[b] else -1 for b in range(4)]
        ri1 = [note_ref(bpos[b][0], bpos[b][1], 2, 2,
                        read_ref_idx(bpos[b][0], bpos[b][1], lst=1), 1)
               if su1[b] else -1 for b in range(4)]
        # shared direct parameters for any B_Direct_8x8 blocks
        dri0, dri1 = direct_ref_indices(ref4, ref4b, gy0, gx0, my0, mbw,
                                        dec4)
        dzero = dri0 < 0 and dri1 < 0
        if dzero:
            dri0 = dri1 = 0
            dmvp0 = dmvp1 = (0, 0)
        else:
            dmvp0 = mv_pred4(mv4, ref4, dec4, gy0, gx0, 4, dri0, my0,
                             mbw) if dri0 >= 0 else (0, 0)
            dmvp1 = mv_pred4(mv4b, ref4b, dec4, gy0, gx0, 4, dri1, my0,
                             mbw) if dri1 >= 0 else (0, 0)
        parts = []  # (gy, gx, pw, ph, mv0, mv1, r0, r1) for the MC pass
        small = False
        dmv = {}
        for b in range(4):
            by, bx = bpos[b]
            if subs[b] == 0:
                cy_, cx_ = direct_corner(gy0, gx0, b, True, 0, 0)
                cz = (not dzero) and col_zero(colmeta, cy_, cx_)
                m0 = (0, 0) if dzero or (cz and dri0 == 0) else dmvp0
                m1 = (0, 0) if dzero or (cz and dri1 == 0) else dmvp1
                fill_list(by, bx, 2, 2, m0, dri0, 0, 0, 0, direct=True)
                fill_list(by, bx, 2, 2, m1, dri1, 0, 0, 1, direct=True)
                dmv[b] = (m0, m1)
                parts.append((by, bx, 2, 2, m0, m1, dri0, dri1))
                continue
            shp, _m = _B_SUB[subs[b]]
            if shp != 0:
                small = True
            for dy, dx, pw, ph in _SUB_PARTS[shp]:
                gy, gx = by + dy, bx + dx
                if su0[b]:
                    mdx, mdy = read_mvd_pair(gy, gx, 0)
                    pmx, pmy = mv_pred4(mv4, ref4, dec4, gy, gx, pw,
                                        ri0[b], my0, mbw)
                    mv0 = (pmx + mdx, pmy + mdy)
                    fill_list(gy, gx, pw, ph, mv0, ri0[b],
                              abs(mdx), abs(mdy), 0)
                else:
                    mv0 = (0, 0)
                    fill_list(gy, gx, pw, ph, mv0, -1, 0, 0, 0)
                parts.append([gy, gx, pw, ph, mv0, None, ri0[b], ri1[b]])
        # L1 pass over the non-direct sub-partitions, in syntax order
        pi = 0
        for b in range(4):
            if subs[b] == 0:
                pi += 1
                continue
            shp, _m = _B_SUB[subs[b]]
            for dy, dx, pw, ph in _SUB_PARTS[shp]:
                ent = parts[pi]
                gy, gx = ent[0], ent[1]
                if su1[b]:
                    mdx, mdy = read_mvd_pair(gy, gx, 1)
                    pmx, pmy = mv_pred4(mv4b, ref4b, dec4, gy, gx, pw,
                                        ri1[b], my0, mbw)
                    mv1 = (pmx + mdx, pmy + mdy)
                    fill_list(gy, gx, pw, ph, mv1, ri1[b],
                              abs(mdx), abs(mdy), 1)
                else:
                    mv1 = (0, 0)
                    fill_list(gy, gx, pw, ph, mv1, -1, 0, 0, 1)
                ent[5] = mv1
                pi += 1
        for ent in parts:
            gy, gx, pw, ph, mv0, mv1, r0, r1 = ent
            part_pred_b(pred16, predc, mx, my, gy, gx, pw, ph,
                        mv0, mv1 if mv1 is not None else (0, 0), r0, r1)
        inter_tail(mx, my, pred16, predc, small)

    # ---- MB loop --------------------------------------------------------

    last_dqp = 0
    cur_intra = False
    mb_addr = first_mb
    n_mbs = mbw * mbh
    while mb_addr < n_mbs:
        my, mx = mb_addr // mbw, mb_addr % mbw
        mb_addr += 1
        if is_b:
            inc = 0
            if mb_avail_a(mx) and not pic.skip[my, mx - 1]:
                inc += 1
            if mb_avail_b(my) and not pic.skip[my - 1, mx]:
                inc += 1
            if eng.decision(24 + inc):  # B mb_skip_flag
                clear_mb_ctx(mx, my, intra=False, skip=True)
                pic.bdirect[my, mx] = True
                decode_b_skip(mx, my)
                last_dqp = 0
                if eng.terminate():
                    break
                continue
            clear_mb_ctx(mx, my, intra=False)
            mb_type = read_b_mb_type(mx, my)
            pic.bdirect[my, mx] = mb_type == 0
            if mb_type >= 23:
                it = mb_type - 23
                cur_intra = True
                for g, v in ((ref4, -1), (ref4b, -1)):
                    g[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = v
                mv4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                mv4b[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                dec4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                rd4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                rd4b[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                decode_intra_mb(mx, my, it)
            else:
                cur_intra = False
                decode_b_mb(mx, my, mb_type)
        elif is_p:
            inc = 0
            if mb_avail_a(mx) and not pic.skip[my, mx - 1]:
                inc += 1
            if mb_avail_b(my) and not pic.skip[my - 1, mx]:
                inc += 1
            if not eng.decision(11 + inc):  # mb_skip_flag == 0 ... inverted?
                skip = False
            else:
                skip = True
            if skip:
                clear_mb_ctx(mx, my, intra=False, skip=True)
                decode_p_skip(mx, my)
                last_dqp = 0
                if eng.terminate():
                    break
                continue
            clear_mb_ctx(mx, my, intra=False)
            # mb_type (P binarization, ctx 14-17)
            if eng.decision(14) == 0:
                if eng.decision(15) == 0:
                    mb_type = 3 * eng.decision(16)  # 0 (16x16) or 3 (8x8)
                else:
                    mb_type = 2 - eng.decision(17)  # 2 (8x16) or 1 (16x8)
                cur_intra = False
                decode_p_mb(mx, my, mb_type)
            else:
                it = _intra_mb_type(eng, 17, False, 0)
                cur_intra = True
                ref4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = -1
                mv4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                dec4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                rd4[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = True
                decode_intra_mb(mx, my, it)
        else:
            clear_mb_ctx(mx, my, intra=True)
            inc = 0
            if mb_avail_a(mx) and pic.i16[my, mx - 1]:
                inc += 1
            if mb_avail_b(my) and pic.i16[my - 1, mx]:
                inc += 1
            cur_intra = True
            mb_type = _intra_mb_type(eng, 3, True, inc)
            decode_intra_mb(mx, my, mb_type)
        if eng.terminate():
            break
