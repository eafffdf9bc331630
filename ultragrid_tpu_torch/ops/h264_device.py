"""Device path of the own H.264 encoder: intra (I_16x16) and P frames in
PyTorch, the counterpart of ``ultragrid_tpu/ops/h264_tpu.py``.

Each frame is one chain of tensor operations on the module's device:
source-neighbour DC prediction (intra) or motion search and compensation
(P), the 4x4 core transforms and the DC Hadamards, quantisation, CAVLC for
every block of the frame in one batched pass, and the MSB-first packing of
each macroblock's symbols into a window of ``wwords`` 32-bit words.  The
host then concatenates the windows with emulation prevention in C
(``native/h264_assemble.c``).  P frames also rebuild the decoder's picture
exactly (dequantisation and the inverse transform), which stays on the
device as the next reference.

The contract is the reference's: access units byte-equal to
``Intra16EncoderTpu`` / ``InterEncoderTpu`` (``tests/test_torch_h264*.py``)
and reconstructions equal to the decoder's.  The TPU-shaped parts of the
reference are written here as PyTorch would: gathers instead of the
``_sel_lookup`` where-chains (h264_tpu.py:42-56) and the one-hot row and
column selects (784-814), the coarse SAD as an int32 sum instead of a bf16
einsum (760-763, exact either way), a closed form for the run_before
state, and one ``scatter_add`` of disjoint int64 bit contributions instead
of the per-word loops of the pack (460-463, 486-488).  The graph is integer
code; its one float step, the bit length of an Exp-Golomb value, is fixed
up to the exact integer (``_ue_bitlen``).

No hand kernel runs here: the reference's stages are XLA graphs, not
Pallas.  A CUDA kernel for the CAVLC and the pack is speed work (ROADMAP
S8).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device
from ultragrid_tpu_torch.ops import h264 as H
from ultragrid_tpu_torch.ops.h264_dec import _CBP_INTER_FWD, MC_PAD, _vmat

_S = 36      # symbol slots of one block: token, 3 signs, 16 levels, tz, 15 runs
_I32 = torch.int32

_UE_N = 64
_UE_VAL = np.arange(_UE_N) + 1
_UE_LEN = np.array([2 * int(i + 1).bit_length() - 1 for i in range(_UE_N)])

_CBP_INTER_FWD_ARR = np.zeros(48, np.int32)
for _c, _i in _CBP_INTER_FWD.items():
    _CBP_INTER_FWD_ARR[_c] = _i

_TZC_BASE = 17 * 16  # chroma-DC total_zeros rows follow the 4x4 ones in one table


@lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The CAVLC code tables and the small constant matrices on ``device``."""
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64).astype(np.int32), device=device)

    # coeff_token: kinds 0 (0 <= nC < 2), 1 (2 <= nC < 4), 2 (4 <= nC < 8),
    # 3 (chroma DC); [kind, t1, total] flattened
    ct_val = np.stack([H._CT_VAL[k] for k in ("0", "2", "4", "c")])
    ct_len = np.stack([H._CT_LEN[k] for k in ("0", "2", "4", "c")])
    tz_val = np.concatenate([H._TZ_VAL.reshape(-1), H._TZC_VAL.reshape(-1)])
    tz_len = np.concatenate([H._TZ_LEN.reshape(-1), H._TZC_LEN.reshape(-1)])
    zz = np.asarray(H._ZZ_IDX)
    return {"ct_val": t(ct_val.reshape(-1)), "ct_len": t(ct_len.reshape(-1)),
            "tz_val": t(tz_val), "tz_len": t(tz_len),
            "rb_val": t(H._RB_VAL.reshape(-1)), "rb_len": t(H._RB_LEN.reshape(-1)),
            "ue_val": t(_UE_VAL), "ue_len": t(_UE_LEN),
            "zz": torch.as_tensor(zz, device=device),
            "unzz": torch.as_tensor(np.argsort(zz), device=device),
            "c4": t(H._C4), "h4": t(H._H4), "h2": t(H._H2),
            "cbp_fwd": t(_CBP_INTER_FWD_ARR), "idx16": t(np.arange(16))}


# ---- small integer matrix products over the last two axes -----------------

def _left(m, x):
    """m @ x over the last two axes (exact int32)."""
    return (m[:, :, None] * x[..., None, :, :]).sum(-2, dtype=_I32)


def _right_t(m, x):
    """x @ m.T over the last two axes (exact int32)."""
    return (x[..., :, :, None] * m.t()).sum(-2, dtype=_I32)


def _core4(x, tb):
    return _right_t(tb["c4"], _left(tb["c4"], x))


def _had(m, x):
    return _right_t(m, _left(m, x))


def _sgn_quant(c, mf, off, shift):
    return torch.sign(c) * ((c.abs() * mf + off) >> shift)


def _mf_matrix(qp: int):
    mfr = H._MF[qp % 6]
    return np.array([[mfr[H._POSCLASS[r][c]] for c in range(4)] for r in range(4)], np.int32)


# ---- CAVLC -----------------------------------------------------------------

def cavlc_blocks(levels, nC, max_coeff, chroma_dc, tb):
    """CAVLC of N blocks in one pass (ref ``cavlc_blocks_jnp``, 84-223).

    ``levels`` [N, 16] int32 zigzag-ordered, zero-padded past the block's
    ``max_coeff`` [N] (16, 15 or 4); ``nC`` [N]; ``chroma_dc`` [N] bool
    selects the chroma-DC coeff_token and total_zeros tables.  Returns
    (values [N, 36], lengths [N, 36]) in the reference's slot layout:
    [0] coeff_token, [1..3] trailing-one signs, [4..19] levels, [20]
    total_zeros, [21..35] run_before."""
    n = levels.shape[0]
    dev = levels.device
    lv = levels
    nzm = lv != 0
    total = nzm.sum(1, dtype=_I32)
    idx = tb["idx16"][None, :]
    nz_after = (nzm.flip(1).cumsum(1, dtype=_I32).flip(1) - nzm.to(_I32))
    big = nzm & (lv.abs() > 1)
    lastbig = torch.where(big, idx, -1).amax(1)
    after_big = nz_after.gather(1, lastbig.clamp(min=0)[:, None])[:, 0]
    t1 = torch.clamp(torch.where(lastbig >= 0, after_big, total), max=3)
    last_nz = torch.where(nzm, idx, -1).amax(1)
    zeros = torch.where(total > 0, last_nz + 1 - total, 0)

    # coeff_token
    kind = torch.where(chroma_dc, 3, torch.where(nC < 2, 0, torch.where(nC < 4, 1, 2)))
    ct_i = (kind * 4 + t1) * 17 + total
    flc = (~chroma_dc) & (nC >= 8)
    ct_v = torch.where(flc, torch.where(total == 0, 3, ((total - 1) << 2) | t1), tb["ct_val"][ct_i])
    ct_l = torch.where(flc, 6, tb["ct_len"][ct_i])

    # the position and level of each nonzero by rank (0 = the last in scan
    # order); column 16 takes the zeros and is dropped
    rank = torch.where(nzm, nz_after, 16).long()
    pos = torch.zeros(n, 17, dtype=_I32, device=dev).scatter_(1, rank, idx.expand(n, 16))[:, :16]
    lvl = torch.zeros(n, 17, dtype=_I32, device=dev).scatter_(1, rank, lv)[:, :16]
    r16 = idx  # rank iota

    # trailing-one signs
    m1 = r16[:, :3] < t1[:, None]
    sign_v = torch.where(m1, (lvl[:, :3] < 0).to(_I32), 0)
    sign_l = m1.to(_I32)

    # levels: suffix_len adapts rank by rank, the rest is elementwise
    m = (r16 >= t1[:, None]) & (r16 < total[:, None])
    a = lvl.abs()
    sl = torch.where((total > 10) & (t1 < 3), 1, 0).to(_I32)
    three = torch.full_like(sl, 3)
    sls = []
    for r in range(16):
        sls.append(sl)
        mr = m[:, r]
        sl = torch.where(mr & (sl == 0), 1, sl)
        grow = mr & (a[:, r] > (three << torch.clamp(sl - 1, min=0))) & (sl < 6)
        sl = sl + grow.to(_I32)
    sl = torch.stack(sls, 1)
    code = torch.where(lvl > 0, 2 * a - 2, 2 * a - 1)
    code = torch.where(m & (r16 == t1[:, None]) & (t1[:, None] < 3), code - 2, code)
    p = code >> sl
    c0 = m & (sl == 0)
    short = c0 & (code < 14)
    val = torch.where(short, 1, 0)
    ln = torch.where(short, code + 1, 0)
    esc14 = c0 & (code >= 14) & (code < 30)
    val = torch.where(esc14, (1 << 4) | (code - 14), val)
    ln = torch.where(esc14, 19, ln)
    esc15_0 = c0 & (code >= 30)
    val = torch.where(esc15_0, (1 << 12) | (code - 30), val)
    ln = torch.where(esc15_0, 28, ln)
    c1 = m & (sl > 0)
    one = torch.ones_like(sl)
    reg = c1 & (p < 15)
    val = torch.where(reg, (one << sl) | (code & ((one << sl) - 1)), val)
    ln = torch.where(reg, p + 1 + sl, ln)
    esc15 = c1 & (p >= 15)
    val = torch.where(esc15, (1 << 12) | (code - ((one * 15) << sl)), val)
    ln = torch.where(esc15, 28, ln)

    # total_zeros
    mt = (total > 0) & (total < max_coeff)
    tz_i = torch.where(chroma_dc, _TZC_BASE + total.clamp(max=3) * 4 + zeros.clamp(max=3),
                       total * 16 + zeros)
    tz_v = torch.where(mt, tb["tz_val"][tz_i], 0)
    tz_l = torch.where(mt, tb["tz_len"][tz_i], 0)

    # run_before: zeros_left before rank r is total_zeros less the zeros
    # between the last coefficient and rank r's (the reference's running
    # count, h264_tpu.py:195-207, in closed form)
    r15 = r16[:, :15]
    zl = zeros[:, None] - (pos[:, :1] - pos[:, :15] - r15)
    mr = (r15 <= total[:, None] - 2) & (zl > 0)
    run = torch.where(mr, pos[:, :15] - pos[:, 1:] - 1, 0)
    rb_i = zl.clamp(0, 7) * 15 + run
    rb_v = torch.where(mr, tb["rb_val"][rb_i], 0)
    rb_l = torch.where(mr, tb["rb_len"][rb_i], 0)

    sval = torch.cat([ct_v[:, None], sign_v, val, tz_v[:, None], rb_v], 1)
    slen = torch.cat([ct_l[:, None], sign_l, ln, tz_l[:, None], rb_l], 1)
    return sval, slen


# ---- the MSB-first pack ------------------------------------------------------

def pack_windows(sval, slen, nmb: int, wwords: int):
    """Symbols [nmb * nb, 36] (block-major within each macroblock) -> each
    macroblock's bits MSB-first in ``wwords`` words (int64 holding u32),
    bit counts [nmb] and the overflow flag.

    Overflow is the reference's (h264_tpu.py:464, 490): a block over its
    level-1 window of max(4, wwords // 10) words or a macroblock over
    ``wwords``; the caller then widens the window.  Symbols are disjoint
    bit ranges of a word, so summing their int64 contributions is their OR.
    """
    dev = sval.device
    nb = slen.shape[0] // nmb
    bw = max(4, wwords // 10)
    blk_bits = slen.sum(1, dtype=_I32)
    ln = slen.reshape(nmb, nb * _S).long()
    ends = ln.cumsum(1)
    mb_bits = ends[:, -1]
    offs = ends - ln
    v = sval.reshape(nmb, nb * _S).long() & ((torch.ones_like(ln) << ln) - 1)
    t = offs & 31
    w0 = offs >> 5
    d = t + ln
    spans = d > 32
    x0 = torch.where(spans, v >> (d - 32).clamp(min=0), v << (32 - d).clamp(min=0))
    x1 = torch.where(spans, (v << (64 - d).clamp(max=63)) & 0xFFFFFFFF, 0)
    # words past the window land in column wwords, which is dropped
    words = torch.zeros(nmb, wwords + 1, dtype=torch.int64, device=dev)
    words.scatter_add_(1, w0.clamp(max=wwords), x0)
    words.scatter_add_(1, (w0 + 1).clamp(max=wwords), x1)
    overflow = (mb_bits.max() > wwords * 32) | (blk_bits.max() > bw * 32)
    return words[:, :wwords], mb_bits.to(_I32), overflow


def _words_to_host(words) -> np.ndarray:
    """int64 words holding u32 -> a uint32 array on the host (half the bytes
    cross as int32)."""
    w32 = torch.where(words >= 1 << 31, words - (1 << 32), words).to(_I32)
    return w32.cpu().numpy().view(np.uint32)


def _bit_window(val: int, nbits: int, width: int) -> np.ndarray:
    """A bit string as one MSB-first row of ``width`` words."""
    val <<= (-nbits) % 32
    nw = (nbits + 31) // 32
    row = np.zeros((1, width), np.uint32)
    row[0, :nw] = [(val >> (32 * (nw - 1 - i))) & 0xFFFFFFFF for i in range(nw)]
    return row


def _writer_bits(w: "H.BitWriter") -> Tuple[int, int]:
    nbits = len(w.bytes) * 8 + w.nbits
    return int.from_bytes(bytes(w.bytes), "big") << w.nbits | w.acc, nbits


def _assemble(wn: np.ndarray, bn: np.ndarray) -> bytes:
    """Rows of MSB-first windows and their bit counts -> the slice payload
    with emulation prevention and the RBSP trailing bits (C assembler)."""
    from ultragrid_tpu_torch.native import h264_assemble_lib

    wn = np.ascontiguousarray(wn)
    bn = np.ascontiguousarray(bn.astype(np.int32))
    total_bits = int(bn.sum())
    cap = total_bits // 8 + total_bits // 64 + 64
    out = np.empty(cap, np.uint8)
    n = h264_assemble_lib().h264_assemble(wn.ctypes.data, bn.ctypes.data, wn.shape[0], wn.shape[1],
                                          out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("h264_assemble: buffer too small")
    return out[:n].tobytes()


# ---- planes ------------------------------------------------------------------

def _edge_index(n: int, before: int, after: int, device):
    return torch.arange(-before, n + after, device=device).clamp(0, n - 1)


def _edge_pad(p, before: int, after_h: int, after_w: int = None):
    """np.pad(mode="edge") of a 2-D tensor, by clamped indices."""
    after_w = after_h if after_w is None else after_w
    h, w = p.shape
    return p[_edge_index(h, before, after_h, p.device)][:, _edge_index(w, before, after_w, p.device)]


def uyvy_to_planes(frame, width: int, height: int):
    """UYVY [H, 2W] u8 tensor -> 4:2:0 planes edge-padded to whole
    macroblocks, as ``H.uyvy_to_i420`` followed by ``H._pad_to_mb``."""
    a = frame[:height, : 2 * width]
    if height & 1:
        a = torch.cat([a, a[-1:]], 0)
    y = a[:height, 1::2]
    c = a[:, 0::2].to(torch.int16).reshape(a.shape[0] // 2, 2, -1)
    c = ((c[:, 0] + c[:, 1] + 1) >> 1).to(torch.uint8)
    cb, cr = c[:, 0::2], c[:, 1::2]
    ph, pw = (height + 15) & ~15, (width + 15) & ~15
    y = _edge_pad(y, 0, ph - height, pw - width)
    cb = _edge_pad(cb, 0, ph // 2 - cb.shape[0], pw // 2 - cb.shape[1])
    cr = _edge_pad(cr, 0, ph // 2 - cr.shape[0], pw // 2 - cr.shape[1])
    return y, cb, cr


def _to_device_planes(y, cb, cr, device):
    """Host (numpy) or device planes -> u8 tensors on ``device``, edge-padded
    to whole macroblocks."""
    out = []
    for p in (y, cb, cr):
        out.append(p.to(device) if isinstance(p, torch.Tensor) else torch.as_tensor(np.asarray(p), device=device))
    y, cb, cr = out
    h, w = y.shape
    ph, pw = (h + 15) & ~15, (w + 15) & ~15
    return (_edge_pad(y, 0, ph - h, pw - w), _edge_pad(cb, 0, ph // 2 - cb.shape[0], pw // 2 - cb.shape[1]),
            _edge_pad(cr, 0, ph // 2 - cr.shape[0], pw // 2 - cr.shape[1]))


def _frame_tensor(frame, device):
    if isinstance(frame, torch.Tensor):
        return frame.to(device)
    return torch.as_tensor(np.ascontiguousarray(frame), device=device)


def _nc_grid(nn):
    gh, gw = nn.shape
    na = torch.cat([torch.full((gh, 1), -1, dtype=_I32, device=nn.device), nn[:, :-1]], 1)
    nb = torch.cat([torch.full((1, gw), -1, dtype=_I32, device=nn.device), nn[:-1]], 0)
    both = (na >= 0) & (nb >= 0)
    return torch.where(both, (na + nb + 1) >> 1, torch.where(na >= 0, na, torch.where(nb >= 0, nb, 0)))


def _blocks_of(grid, mbh, mbw, k):
    """A [mbh*k, mbw*k] per-4x4 grid -> [nmb, k*k] in raster order."""
    return grid.reshape(mbh, k, mbw, k).permute(0, 2, 1, 3).reshape(mbh * mbw, k * k)


_LUMA_ORDER = [by * 4 + bx for bx, by in H._BLK_ORDER]


@lru_cache(maxsize=None)
def _family_columns(device, dc_first: bool):
    """Per-block-slot constants of one macroblock's CAVLC blocks: the max
    coefficient count and the chroma-DC flag, for [DC,] 16 luma, 2 chroma
    DC, 8 chroma AC."""
    mc = ([16] if dc_first else []) + [15 if dc_first else 16] * 16 + [4, 4] + [15] * 8
    cd = ([False] if dc_first else []) + [False] * 16 + [True, True] + [False] * 8
    return (torch.tensor(mc, dtype=_I32, device=device), torch.tensor(cd, device=device))


def _pad16(x):
    return torch.nn.functional.pad(x, (0, 16 - x.shape[-1]))


def _header_block(hv, hl):
    """[nmb, k] header symbols -> a 36-slot pseudo-block."""
    return (torch.nn.functional.pad(hv, (0, _S - hv.shape[1])), torch.nn.functional.pad(hl, (0, _S - hl.shape[1])))


# ---- intra (I_16x16, DC prediction from source neighbours) ------------------

def make_device_encode(width: int, height: int, qp: int, wwords: int = 80, device="cuda"):
    """The whole-frame intra encode (ref ``make_device_encode``, 226-493):
    padded 4:2:0 planes (u8 tensors on ``device``) -> (macroblock words
    [nmb, wwords] int64 holding u32, bit counts [nmb] int32, overflow)."""
    device = get_device(device) if isinstance(device, str) else device
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    nmb = mbw * mbh
    qpc = H.chroma_qp(qp)
    tb = _tables(device)
    qbits, qbc = 15 + qp // 6, 15 + qpc // 6
    mf = torch.as_tensor(_mf_matrix(qp), device=device)
    mfc = torch.as_tensor(_mf_matrix(qpc), device=device)
    f_off, fc_off = (1 << qbits) // 3, (1 << qbc) // 3
    mf0, mf0c = int(H._MF[qp % 6][0]), int(H._MF[qpc % 6][0])
    has_t = torch.zeros(mbh, mbw, dtype=torch.bool, device=device)
    has_t[1:] = True
    has_l = torch.zeros(mbh, mbw, dtype=torch.bool, device=device)
    has_l[:, 1:] = True
    max_coeff, chroma_dc = _family_columns(device, True)

    def encode(y, cb, cr):
        yi = y.to(_I32)
        bottom = yi[15::16, :].reshape(mbh, mbw, 16).sum(2, dtype=_I32)
        right = yi[:, 15::16].reshape(mbh, 16, mbw).sum(1, dtype=_I32)
        top_sum = torch.cat([torch.zeros(1, mbw, dtype=_I32, device=device), bottom[:-1]], 0)
        left_sum = torch.cat([torch.zeros(mbh, 1, dtype=_I32, device=device), right[:, :-1]], 1)
        pred = torch.where(has_t & has_l, (top_sum + left_sum + 16) >> 5,
                           torch.where(has_l, (left_sum + 8) >> 4, torch.where(has_t, (top_sum + 8) >> 4, 128)))
        res = yi.reshape(mbh, 16, mbw, 16).permute(0, 2, 1, 3) - pred[:, :, None, None]
        coefs = _core4(res.reshape(mbh, mbw, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5), tb)
        dc_had = _had(tb["h4"], coefs[..., 0, 0].contiguous())
        # JM: floor-div by 2 (python // semantics for negatives)
        dc_had = torch.where(dc_had >= 0, dc_had >> 1, -((-dc_had + 1) >> 1))
        dc_lv = _sgn_quant(dc_had, mf0, 2 * f_off, qbits + 1)
        ac_lv = _sgn_quant(coefs, mf, f_off, qbits)
        ac_lv[..., 0, 0] = 0
        cbp_luma = (ac_lv.reshape(mbh, mbw, -1) != 0).any(2)

        cdc_lv, zz_cac = [], []
        for plane in (cb, cr):
            pc = plane.to(_I32)
            tq = torch.cat([torch.zeros(1, mbw, 2, dtype=_I32, device=device),
                            pc[7::8][:-1].reshape(mbh - 1, mbw, 2, 4).sum(3, dtype=_I32)], 0)
            lq = torch.cat([torch.zeros(mbh, 1, 2, dtype=_I32, device=device),
                            pc[:, 7::8][:, :-1].reshape(mbh, 2, 4, mbw - 1).sum(2, dtype=_I32).permute(0, 2, 1)], 1)
            ht, hl = has_t, has_l
            t0, t1_, l0, l1 = tq[..., 0], tq[..., 1], lq[..., 0], lq[..., 1]
            c00 = torch.where(ht & hl, (t0 + l0 + 4) >> 3,
                              torch.where(hl, (l0 + 2) >> 2, torch.where(ht, (t0 + 2) >> 2, 128)))
            c01 = torch.where(ht, (t1_ + 2) >> 2, torch.where(hl, (l0 + 2) >> 2, 128))
            c10 = torch.where(hl, (l1 + 2) >> 2, torch.where(ht, (t0 + 2) >> 2, 128))
            c11 = torch.where(ht & hl, (t1_ + l1 + 4) >> 3,
                              torch.where(hl, (l1 + 2) >> 2, torch.where(ht, (t1_ + 2) >> 2, 128)))
            cpred = torch.stack([c00, c01, c10, c11], -1).reshape(mbh, mbw, 2, 2)
            cres = pc.reshape(mbh, 8, mbw, 8).permute(0, 2, 1, 3).reshape(mbh, mbw, 2, 4, 2, 4)
            cres = cres.permute(0, 1, 2, 4, 3, 5) - cpred[..., None, None]
            cc = _core4(cres, tb)
            dc2 = _had(tb["h2"], cc[..., 0, 0].contiguous())
            cdc_lv.append(_sgn_quant(dc2, mf0c, 2 * fc_off, qbc + 1))
            a = _sgn_quant(cc, mfc, fc_off, qbc)
            a[..., 0, 0] = 0
            zz_cac.append(a.reshape(mbh, mbw, 2, 2, 16)[..., tb["zz"]][..., 1:])
        any_cac = (zz_cac[0] != 0).reshape(mbh, mbw, -1).any(2) | (zz_cac[1] != 0).reshape(mbh, mbw, -1).any(2)
        any_cdc = (cdc_lv[0] != 0).reshape(mbh, mbw, -1).any(2) | (cdc_lv[1] != 0).reshape(mbh, mbw, -1).any(2)
        cbp_chroma = torch.where(any_cac, 2, torch.where(any_cdc, 1, 0))

        zz_ac = ac_lv.reshape(mbh, mbw, 4, 4, 16)[..., tb["zz"]][..., 1:]
        tot_l = (zz_ac != 0).sum(4, dtype=_I32)
        nnz_l = (tot_l * cbp_luma[:, :, None, None]).permute(0, 2, 1, 3).reshape(mbh * 4, mbw * 4)
        keep_ca = cbp_chroma == 2
        nnz_c = [((z != 0).sum(4, dtype=_I32) * keep_ca[:, :, None, None]).permute(0, 2, 1, 3)
                 .reshape(mbh * 2, mbw * 2) for z in zz_cac]
        ncl = _nc_grid(nnz_l)
        ncc = [_nc_grid(nn) for nn in nnz_c]

        # one CAVLC pass over the 27 blocks of every macroblock
        zz_dc = dc_lv.reshape(mbh, mbw, 16)[..., tb["zz"]].reshape(nmb, 1, 16)
        lum = _pad16(zz_ac.reshape(nmb, 16, 15)[:, _LUMA_ORDER])
        cdc = _pad16(torch.stack([cdc_lv[0].reshape(nmb, 4), cdc_lv[1].reshape(nmb, 4)], 1))
        cac = _pad16(torch.cat([zz_cac[0].reshape(nmb, 4, 15), zz_cac[1].reshape(nmb, 4, 15)], 1))
        levels = torch.cat([zz_dc, lum, cdc, cac], 1)
        ncl_b = _blocks_of(ncl, mbh, mbw, 4)
        nc = torch.cat([ncl_b[:, :1], ncl_b[:, _LUMA_ORDER], torch.zeros(nmb, 2, dtype=_I32, device=device),
                        _blocks_of(ncc[0], mbh, mbw, 2), _blocks_of(ncc[1], mbh, mbw, 2)], 1)
        nblk = levels.shape[1]
        sv, sl = cavlc_blocks(levels.reshape(-1, 16), nc.reshape(-1), max_coeff.repeat(nmb),
                              chroma_dc.repeat(nmb), tb)
        keep = torch.cat([torch.ones(nmb, 1, dtype=torch.bool, device=device),
                          cbp_luma.reshape(nmb, 1).expand(nmb, 16),
                          (cbp_chroma > 0).reshape(nmb, 1).expand(nmb, 2),
                          keep_ca.reshape(nmb, 1).expand(nmb, 8)], 1).reshape(-1, 1)
        sv = (sv * keep).reshape(nmb, nblk, _S)
        sl = (sl * keep).reshape(nmb, nblk, _S)
        # the header rides as a pseudo-block: mb_type, chroma pred mode
        # ue(0), mb_qp_delta se(0)
        mb_type = (3 + 4 * cbp_chroma + 12 * cbp_luma.to(_I32)).reshape(-1).long()
        one = torch.ones(nmb, dtype=_I32, device=device)
        hv, hl_ = _header_block(torch.stack([tb["ue_val"][mb_type], one, one], 1),
                                torch.stack([tb["ue_len"][mb_type], one, one], 1))
        sval = torch.cat([hv[:, None], sv], 1).reshape(-1, _S)
        slen = torch.cat([hl_[:, None], sl], 1).reshape(-1, _S)
        return pack_windows(sval, slen, nmb, wwords)

    return encode


class Intra16EncoderDevice:
    """Device H.264 intra encoder: one chain of tensor operations per frame
    and the host C assembly (ref ``Intra16EncoderTpu``, 496-577).

    Byte-equal to Intra16EncoderTpu, hence to Intra16EncoderV.  Runs on
    ``device``, the card unless the caller names another."""

    def __init__(self, width: int, height: int, qp: int = 26, wwords: int = 40, device="cuda"):
        self.device = get_device(device) if not isinstance(device, torch.device) else device
        self.width, self.height = width, height
        self.qp = qp
        self.wwords = wwords
        self.mb_w = (width + 15) // 16
        self.mb_h = (height + 15) // 16
        self.headers = H.make_sps(width, height) + H.make_pps(qp)
        self._fns = {}
        # the slice header as a prefix window for the C assembler
        hw = H.BitWriter()
        H._slice_header(hw, 0, 0, 0, disable_deblock=True)
        self._hdr_val, self._hdr_bits = _writer_bits(hw)

    def _fn(self):
        fn = self._fns.get(self.wwords)
        if fn is None:
            fn = self._fns[self.wwords] = make_device_encode(self.width, self.height, self.qp, self.wwords,
                                                             self.device)
        return fn

    def _encode(self, y, cb, cr) -> bytes:
        words, bits, ovf = self._fn()(y, cb, cr)
        while bool(ovf) and self.wwords < 1024:
            self.wwords *= 4  # one jump reaches intra-grade windows
            words, bits, ovf = self._fn()(y, cb, cr)
        wn = _words_to_host(words)
        wn = np.concatenate([_bit_window(self._hdr_val, self._hdr_bits, wn.shape[1]), wn])
        bn = np.concatenate([[self._hdr_bits], bits.cpu().numpy()])
        start = b"\x00\x00\x00\x01" + bytes([(3 << 5) | 5])
        return self.headers + start + _assemble(wn, bn)

    def encode_planes(self, y, cb, cr) -> bytes:
        """4:2:0 planes (arrays or tensors) -> SPS + PPS + IDR slice."""
        return self._encode(*_to_device_planes(y, cb, cr, self.device))

    def encode_uyvy(self, frame) -> bytes:
        """A UYVY frame (array, or tensor on the module's device) -> SPS +
        PPS + IDR slice; the 4:2:0 split runs on the device."""
        return self._encode(*uyvy_to_planes(_frame_tensor(frame, self.device), self.width, self.height))


# ---- P frames ----------------------------------------------------------------

def _ue_bitlen(v1):
    """Exact bit length of v1 (1 <= v1 < 2^31): float log2 with integer
    fix-ups for the power-of-two edges (ref 594-600).  The float step may
    be one off either way (float32 rounds 2^30 - 1 up to 2^30, and log2
    differs by an ulp between libraries); the fix-ups shift in int64, so a
    first guess of 31 does not wrap."""
    bl = torch.floor(torch.log2(v1.to(torch.float32))).to(torch.int64) + 1
    v = v1.to(torch.int64)
    one = torch.ones_like(bl)
    bl = torch.where((one << bl) <= v, bl + 1, bl)
    bl = torch.where((one << (bl - 1)) > v, bl - 1, bl)
    return bl.to(_I32)


def _ue_sym2(v):
    """ue(v) as two slots (leading zeros, value) so lengths stay <= 28."""
    v1 = (v + 1).to(_I32)
    bl = _ue_bitlen(v1)
    return (torch.zeros_like(v1), bl - 1), (v1, bl)


def _se_sym2(v):
    return _ue_sym2(torch.where(v > 0, 2 * v - 1, -2 * v).to(_I32))


def _itransform4(d):
    """Batched spec 8.5.12.2 inverse transform over [..., 4, 4] int32."""
    def pass1(x):
        x0, x1, x2, x3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
        e0, e1 = x0 + x2, x0 - x2
        e2, e3 = (x1 >> 1) - x3, x1 + (x3 >> 1)
        return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -2)

    return pass1(pass1(d.transpose(-1, -2)).transpose(-1, -2))


def _first_min(sads):
    """(min, index of the first candidate reaching it) over axis 0: the
    reference's "first min wins" (jnp.argmin; strict-less chains)."""
    best = sads.amin(0)
    c = sads.shape[0]
    iota = torch.arange(c, dtype=_I32, device=sads.device).reshape((c,) + (1,) * (sads.dim() - 1))
    return best, torch.where(sads == best, iota, c).amin(0).long()


def _tap6(a, dim):
    """The 6-tap half-sample filter (spec 8.4.2.2.1) along ``dim``, unrounded."""
    n = a.shape[dim] - 5
    s = [a.narrow(dim, k, n) for k in range(6)]
    return s[0] - 5 * s[1] + 20 * s[2] + 20 * s[3] - 5 * s[4] + s[5]


def _sad16(cur, cand):
    """Sum of |cur - cand| over the last two axes (int32)."""
    return (cur - cand).abs().sum((-1, -2), dtype=_I32)


def _pick(xc, want):
    # xc odd: the even neighbour with residue ``want`` mod 4
    return torch.where((xc - 1) % 4 == want, xc - 1, xc + 1)


# the stage ablation's exits, in graph order (ref ``_stop_after``)
STOP_STAGES = ("coarse", "extract", "halfpel", "chroma", "residual")


def make_device_encode_p(width: int, height: int, qp: int, search: int = 8, wwords: int = 80,
                         _stop_after: Optional[str] = None, subpel: str = "half", device="cuda"):
    """The P-frame encode (ref ``make_device_encode_p``, 630-1268): padded
    planes (y, cb, cr) and the reference picture (ry, rcb, rcr), u8 tensors
    on ``device`` -> (words, bit counts, overflow, recon y, cb, cr).

    ``subpel``: "half" (default) or "quarter" (an 8-candidate quarter-pel
    refine around the half-pel best, spec 8.4.2.2.2 averaging).

    ``_stop_after`` (a stage of :data:`STOP_STAGES`) ends the graph early for
    the stage ablation of ``tools/bench_h264_enc_dev.py`` and returns the
    reference's tuple in its layout: ``(ci,)`` the coarse candidate
    [mbh, mbw]; ``(W20,)`` u8 [4, mbh, 20, mbw, 20]; ``(pred_y8, mvx, mvy)``
    with the luma prediction u8 [mbh, 16, mbw, 16]; ``(pred_y, pred_cb,
    pred_cr, mvx, mvy)`` int32 [mbh, 16|8, mbw, 16|8]; ``(cbp, zz_l, mvx,
    mvy)``.  Without a search only "residual" is reached, as in the
    reference."""
    if search > 10:
        raise ValueError("search range > 10 exceeds the MC_PAD window")
    if _stop_after is not None and _stop_after not in STOP_STAGES:
        raise ValueError(f"_stop_after={_stop_after!r}: expected one of {STOP_STAGES}")
    device = get_device(device) if isinstance(device, str) else device
    mbw, mbh = (width + 15) // 16, (height + 15) // 16
    nmb = mbw * mbh
    Hl, Wl = mbh * 16, mbw * 16
    Hc, Wc = mbh * 8, mbw * 8
    qpc = H.chroma_qp(qp)
    tb = _tables(device)
    qbits, qbc = 15 + qp // 6, 15 + qpc // 6
    mf = torch.as_tensor(_mf_matrix(qp), device=device)
    mfc = torch.as_tensor(_mf_matrix(qpc), device=device)
    f_off, fc_off = (1 << qbits) // 3, (1 << qbc) // 3
    mf0c = int(H._MF[qpc % 6][0])
    vy_m = torch.as_tensor(_vmat(qp).astype(np.int32), device=device)
    vc_m = torch.as_tensor(_vmat(qpc).astype(np.int32), device=device)
    v00c = int(_vmat(qpc)[0, 0])
    max_coeff, chroma_dc = _family_columns(device, False)
    # macroblock origins in the MC_PAD-padded planes
    my_o = torch.arange(mbh, device=device)[:, None] * 16 + MC_PAD
    mx_o = torch.arange(mbw, device=device)[None, :] * 16 + MC_PAD
    myc_o = torch.arange(mbh, device=device)[:, None] * 8 + MC_PAD
    mxc_o = torch.arange(mbw, device=device)[None, :] * 8 + MC_PAD
    Wp, Wcp = Wl + 2 * MC_PAD, Wc + 2 * MC_PAD
    ar = {n: torch.arange(n, device=device) for n in (9, 16, 18, 25)}
    gidx = torch.tensor([(by // 2) * 2 + bx // 2 for by in range(4) for bx in range(4)], device=device)
    # neighbour availability (spec 6.4.11.7) for the MV predictor
    availA = np.zeros((mbh, mbw), bool)
    availA[:, 1:] = True
    availB = np.zeros((mbh, mbw), bool)
    availB[1:, :] = True
    availC = np.zeros((mbh, mbw), bool)
    availC[1:, :-1] = True
    availD = np.zeros((mbh, mbw), bool)
    availD[1:, 1:] = True
    availCD = availC | availD
    jA, jB, jC, jCD = (torch.as_tensor(a, device=device) for a in (availA, availB, availC, availCD))
    navail = torch.as_tensor(availA.astype(np.int32) + availB + availCD, device=device)
    geo = torch.as_tensor(~availB & ~availCD & availA, device=device)
    if search:
        Sh = max(1, (search + 1) // 2)
        offs = [(0, 0)] + [(dx, dy) for dy in range(-Sh, Sh + 1) for dx in range(-Sh, Sh + 1) if (dx, dy) != (0, 0)]
        # the coarse candidates in the reference's order, as indices of the
        # raster (dy, dx) grid
        order = torch.tensor([(dy + Sh) * (2 * Sh + 1) + dx + Sh for dx, dy in offs], device=device)
        off_x = torch.tensor([dx for dx, _ in offs], dtype=_I32, device=device)
        off_y = torch.tensor([dy for _, dy in offs], dtype=_I32, device=device)
        deltas = [(0, 0)] + [(dx, dy) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dx, dy) != (0, 0)]
        quarter = [(1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1)]

        def ivec(v):
            return torch.tensor(v, dtype=_I32, device=device)

        dxs, dys = ivec([d_[0] for d_ in deltas]), ivec([d_[1] for d_ in deltas])
        hdxs, hdys = ivec([d_[0] for d_ in H._HALF_OFFS]), ivec([d_[1] for d_ in H._HALF_OFFS])
        qdxs, qdys = ivec([q[0] for q in quarter]), ivec([q[1] for q in quarter])
        mb_base = torch.arange(mbh * mbw, device=device).reshape(mbh, mbw) * 324
    cbp_bits = torch.tensor([1, 2, 4, 8], dtype=_I32, device=device)

    def window(plane_flat, wp, oy, ox, n):
        """Per-macroblock n x n windows of a padded plane whose top-left
        corners are (oy, ox) [mbh, mbw] -> [mbh, mbw, n, n]."""
        r = (oy[..., None] + ar[n]) * wp
        c = ox[..., None] + ar[n]
        return plane_flat[r[..., :, None] + c[..., None, :]]

    def shifted(a, dx, dy, avail):
        out = torch.zeros_like(a)
        ys = slice(max(0, -dy), mbh - max(0, dy))
        xs = slice(max(0, -dx), mbw - max(0, dx))
        ys_s = slice(max(0, dy), mbh - max(0, -dy))
        xs_s = slice(max(0, dx), mbw - max(0, -dx))
        out[ys, xs] = a[ys_s, xs_s]
        return torch.where(avail, out, torch.zeros_like(out))

    def encode(y, cb, cr, ry, rcb, rcr):
        cur_b = y.to(_I32).reshape(mbh, 16, mbw, 16).permute(0, 2, 1, 3)
        rpy = _edge_pad(ry, MC_PAD, MC_PAD).to(_I32)
        rpc = [_edge_pad(p, MC_PAD, MC_PAD).to(_I32) for p in (rcb, rcr)]
        refb = ry.to(_I32).reshape(mbh, 16, mbw, 16).permute(0, 2, 1, 3)

        if not search:
            # zero-MV path: the co-located reference block, chroma frac 0
            pred_y = refb
            pred_c = [p.to(_I32).reshape(mbh, 8, mbw, 8).permute(0, 2, 1, 3) for p in (rcb, rcr)]
            mvx = torch.zeros(mbh, mbw, dtype=_I32, device=device)
            mvy = torch.zeros_like(mvx)
        else:
            # (1) coarse: full search on half-resolution planes, 8x8 SADs,
            # zero candidate first
            def half(p):
                return (p.to(_I32).reshape(Hl // 2, 2, Wl // 2, 2).sum((1, 3), dtype=_I32) + 2) >> 2

            cur_h = half(y).to(torch.int16)
            refh_p = _edge_pad(half(ry), Sh, Sh).to(torch.int16)
            cand = refh_p.unfold(0, Hl // 2, 1).unfold(1, Wl // 2, 1)   # [2Sh+1, 2Sh+1, Hl/2, Wl/2]
            d = (cand - cur_h).abs().reshape(-1, mbh, 8, mbw, 8)
            s = d.sum((2, 4), dtype=_I32)[order]
            _, ci = _first_min(s)
            if _stop_after == "coarse":
                return (ci.to(_I32),)
            ty0 = 2 * off_y[ci]
            tx0 = 2 * off_x[ci]

            # (2) one 25x25 integer window per macroblock at the coarse MV
            # (origin 4 up and left), and the half-sample planes in it
            W25 = window(rpy.reshape(-1), Wp, my_o + ty0 - 4, mx_o + tx0 - 4, 25)
            w_b1 = _tap6(W25, -1)     # [.., 25, 20] x + 1/2
            w_h1 = _tap6(W25, -2)     # [.., 20, 25] y + 1/2
            w_j1 = _tap6(w_b1, -2)    # [.., 20, 20] diagonal
            W20 = torch.stack([W25[..., 2:22, 2:22], torch.clamp((w_b1[..., 2:22, :] + 16) >> 5, 0, 255),
                               torch.clamp((w_h1[..., :, 2:22] + 16) >> 5, 0, 255),
                               torch.clamp((w_j1 + 512) >> 10, 0, 255)])   # [4, mbh, mbw, 20, 20]
            if _stop_after == "extract":
                return (W20.permute(0, 1, 3, 2, 4).to(torch.uint8).contiguous(),)

            # (3a) +-1 integer refine; W20[p] is plane p at (16my+ty0-2+r, 16mx+tx0-2+c)
            cands = torch.stack([W20[0, :, :, 2 + dy:18 + dy, 2 + dx:18 + dx] for dx, dy in deltas])
            best, bi = _first_min(_sad16(cur_b, cands))
            bdx, bdy = dxs[bi], dys[bi]
            ty, tx = ty0 + bdy, tx0 + bdx
            # re-anchor at the refined integer MV: W18[p] is plane p at
            # (16my+ty-1+r, 16mx+tx-1+c)
            ri = (1 + bdy)[..., None] + ar[18]
            cix = (1 + bdx)[..., None] + ar[18]
            sel = (ri[..., :, None] * 20 + cix[..., None, :]).reshape(1, mbh, mbw, 324).expand(4, -1, -1, -1)
            W18 = W20.reshape(4, mbh, mbw, 400).gather(3, sel).reshape(4, mbh, mbw, 18, 18)

            # (3b) half-sample refine
            hc = []
            for hdx, hdy in H._HALF_OFFS:
                fx, fy = hdx & 3, hdy & 3
                pi = 3 if (fx and fy) else (1 if fx else 2)
                ro, co = (hdy >> 2) + 1, (hdx >> 2) + 1
                hc.append(W18[pi, :, :, ro:ro + 16, co:co + 16])
            hc = torch.stack(hc)
            hbest, hi = _first_min(_sad16(cur_b, hc))
            take = hbest < best
            mvx = tx * 4 + torch.where(take, hdxs[hi], 0)
            mvy = ty * 4 + torch.where(take, hdys[hi], 0)
            best = torch.where(take, hbest, best)
            hsel = hc.gather(0, hi.long()[None, :, :, None, None].expand(1, -1, -1, 16, 16))[0]
            pred_y8 = torch.where(take[..., None, None], hsel, W18[0, :, :, 1:17, 1:17])

            if subpel == "quarter":
                # quarter samples average their two even neighbours (spec
                # 8.4.2.2.2), in quarter units from the W18 origin
                # (ty-1, tx-1): the half-pel best sits at (X0, Y0), each in
                # {2, 4, 6}
                X0 = mvx - 4 * tx + 4
                Y0 = mvy - 4 * ty + 4
                W18f = W18.reshape(-1)

                def grid(ex, ey):
                    xh, yh = ex % 4 == 2, ey % 4 == 2
                    p = xh.to(_I32) + 2 * yh.to(_I32)
                    co = (ex - torch.where(xh, 2, 0)) // 4
                    ro = (ey - torch.where(yh, 2, 0)) // 4
                    base = p * (mbh * mbw * 324) + mb_base + ro * 18 + co
                    return W18f[base[..., None, None] + ar[16][:, None] * 18 + ar[16][None, :]]

                qc = []
                for qdx, qdy in quarter:
                    if qdy == 0:
                        qc.append((pred_y8 + grid(X0 + 2 * qdx, Y0) + 1) >> 1)
                    elif qdx == 0:
                        qc.append((pred_y8 + grid(X0, Y0 + 2 * qdy) + 1) >> 1)
                    else:
                        bsrc = grid(_pick(X0 + qdx, 2), _pick(Y0 + qdy, 0))
                        hsrc = grid(_pick(X0 + qdx, 0), _pick(Y0 + qdy, 2))
                        qc.append((bsrc + hsrc + 1) >> 1)
                qc = torch.stack(qc)
                qbest, qi = _first_min(_sad16(cur_b, qc))
                take = qbest < best
                mvx = mvx + torch.where(take, qdxs[qi], 0)
                mvy = mvy + torch.where(take, qdys[qi], 0)
                best = torch.where(take, qbest, best)
                qsel = qc.gather(0, qi.long()[None, :, :, None, None].expand(1, -1, -1, 16, 16))[0]
                pred_y8 = torch.where(take[..., None, None], qsel, pred_y8)

            if _stop_after == "halfpel":
                return (pred_y8.permute(0, 2, 1, 3).to(torch.uint8).contiguous(), mvx, mvy)
            # the zero MV wins ties (skip bias)
            mz = _sad16(cur_b, refb) <= best
            mvx = torch.where(mz, 0, mvx)
            mvy = torch.where(mz, 0, mvy)
            pred_y = torch.where(mz[..., None, None], refb, pred_y8)

            # (4) chroma: eighth-sample bilinear from per-MB 9x9 windows
            cxi, cxf = mvx >> 3, mvx & 7
            cyi, cyf = mvy >> 3, mvy & 7
            wxf, wyf = cxf[..., None, None], cyf[..., None, None]
            pred_c = []
            for p in rpc:
                W9 = window(p.reshape(-1), Wcp, myc_o + cyi, mxc_o + cxi, 9)
                a_, b_ = W9[..., :8, :8], W9[..., :8, 1:9]
                c_, d_ = W9[..., 1:9, :8], W9[..., 1:9, 1:9]
                pred_c.append(((8 - wxf) * (8 - wyf) * a_ + wxf * (8 - wyf) * b_
                               + (8 - wxf) * wyf * c_ + wxf * wyf * d_ + 32) >> 6)
            if _stop_after == "chroma":
                return tuple(p.permute(0, 2, 1, 3).contiguous() for p in (pred_y, *pred_c)) + (mvx, mvy)

        # ---- luma residual: 16-coefficient blocks ----
        b44 = (cur_b - pred_y).reshape(mbh, mbw, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5)
        q_l = _sgn_quant(_core4(b44, tb), mf, f_off, qbits)
        zz_l = q_l.reshape(mbh, mbw, 4, 4, 16)[..., tb["zz"]]
        nzb = (zz_l != 0).any(4)                                     # [mbh, mbw, 4, 4]
        grp = nzb.reshape(mbh, mbw, 2, 2, 2, 2).any(5).any(3).reshape(mbh, mbw, 4)
        cbp_luma = (grp.to(_I32) * cbp_bits).sum(2, dtype=_I32)

        # ---- chroma residual ----
        cdc_lv, zz_cac = [], []
        for plane, predc in zip((cb, cr), pred_c):
            cres = plane.to(_I32).reshape(mbh, 8, mbw, 8).permute(0, 2, 1, 3) - predc
            cc = _core4(cres.reshape(mbh, mbw, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5), tb)
            dc2 = _had(tb["h2"], cc[..., 0, 0].contiguous())
            cdc_lv.append(_sgn_quant(dc2, mf0c, 2 * fc_off, qbc + 1))
            a = _sgn_quant(cc, mfc, fc_off, qbc)
            a[..., 0, 0] = 0
            zz_cac.append(a.reshape(mbh, mbw, 2, 2, 16)[..., tb["zz"]][..., 1:])
        any_cac = (zz_cac[0] != 0).reshape(mbh, mbw, -1).any(2) | (zz_cac[1] != 0).reshape(mbh, mbw, -1).any(2)
        any_cdc = (cdc_lv[0] != 0).reshape(mbh, mbw, -1).any(2) | (cdc_lv[1] != 0).reshape(mbh, mbw, -1).any(2)
        cbp_chroma = torch.where(any_cac, 2, torch.where(any_cdc, 1, 0)).to(_I32)
        cbp = cbp_luma | (cbp_chroma << 4)
        if _stop_after == "residual":
            return cbp, zz_l, mvx, mvy

        # ---- MV prediction and skip (spec 8.4.1.3, 8.4.1.1) ----
        pm = []
        for a in (mvx, mvy):
            va = shifted(a, -1, 0, jA)
            vb = shifted(a, 0, -1, jB)
            vc = torch.where(jC, shifted(a, 1, -1, jC), shifted(a, -1, -1, jCD))
            med = torch.maximum(torch.minimum(va, vb), torch.minimum(torch.maximum(va, vb), vc))
            only = torch.where(jA, va, 0) + torch.where(jB, vb, 0) + torch.where(jCD, vc, 0)
            pm.append(torch.where(geo, va, torch.where(navail == 1, only, med)))
        pmx, pmy = pm
        zero_mv = ((mvx == 0) & (mvy == 0)).to(_I32)
        za = shifted(zero_mv, -1, 0, jA)
        zb = shifted(zero_mv, 0, -1, jB)
        force0 = (~jA) | (~jB) | (jA & (za != 0)) | (jB & (zb != 0))
        skip = (cbp == 0) & (mvx == torch.where(force0, 0, pmx)) & (mvy == torch.where(force0, 0, pmy))
        coded = (~skip).reshape(-1)

        # skip runs: the run before coded MB i is i - (the coded MB before i) - 1
        idx = torch.arange(nmb, dtype=_I32, device=device)
        prev_incl = torch.cummax(torch.where(coded, idx, -1), 0).values
        prevb = torch.cat([torch.full((1,), -1, dtype=_I32, device=device), prev_incl[:-1]])
        run = idx - prevb - 1

        # ---- nnz / nC ----
        blk_coded = grp[:, :, gidx].reshape(mbh, mbw, 4, 4) & coded.reshape(mbh, mbw, 1, 1)
        tot_l = (zz_l != 0).sum(4, dtype=_I32)
        nnz_l = (tot_l * blk_coded).permute(0, 2, 1, 3).reshape(mbh * 4, mbw * 4)
        keep_cac = (cbp_chroma == 2) & coded.reshape(mbh, mbw)
        nnz_c = [((z != 0).sum(4, dtype=_I32) * keep_cac[:, :, None, None]).permute(0, 2, 1, 3)
                 .reshape(mbh * 2, mbw * 2) for z in zz_cac]
        ncl = _nc_grid(nnz_l)
        ncc = [_nc_grid(nn) for nn in nnz_c]

        # ---- symbols: a 10-slot header pseudo-block and 26 blocks ----
        (rz_v, rz_l), (rv_v, rv_l) = _ue_sym2(run)
        (xz_v, xz_l), (xv_v, xv_l) = _se_sym2((mvx - pmx).reshape(-1))
        (yz_v, yz_l), (yv_v, yv_l) = _se_sym2((mvy - pmy).reshape(-1))
        (cz_v, cz_l), (cv_v, cv_l) = _ue_sym2(tb["cbp_fwd"][cbp.reshape(-1).long()])
        has_cbp = (cbp.reshape(-1) != 0).to(_I32)
        ones = torch.ones(nmb, dtype=_I32, device=device)
        hv, hl = _header_block(torch.stack([rz_v, rv_v, ones, xz_v, xv_v, yz_v, yv_v, cz_v, cv_v, ones], 1),
                               torch.stack([rz_l, rv_l, ones, xz_l, xv_l, yz_l, yv_l, cz_l, cv_l, has_cbp], 1))
        lum = zz_l.reshape(nmb, 16, 16)[:, _LUMA_ORDER]
        cdc = _pad16(torch.stack([cdc_lv[0].reshape(nmb, 4), cdc_lv[1].reshape(nmb, 4)], 1))
        cac = _pad16(torch.cat([zz_cac[0].reshape(nmb, 4, 15), zz_cac[1].reshape(nmb, 4, 15)], 1))
        levels = torch.cat([lum, cdc, cac], 1)
        ncl_b = _blocks_of(ncl, mbh, mbw, 4)[:, _LUMA_ORDER]
        nc = torch.cat([ncl_b, torch.zeros(nmb, 2, dtype=_I32, device=device),
                        _blocks_of(ncc[0], mbh, mbw, 2), _blocks_of(ncc[1], mbh, mbw, 2)], 1)
        sv, sl = cavlc_blocks(levels.reshape(-1, 16), nc.reshape(-1), max_coeff.repeat(nmb),
                              chroma_dc.repeat(nmb), tb)
        keep = torch.cat([blk_coded.reshape(nmb, 16)[:, _LUMA_ORDER],
                          ((cbp_chroma.reshape(-1) > 0) & coded)[:, None].expand(nmb, 2),
                          keep_cac.reshape(nmb, 1).expand(nmb, 8)], 1).reshape(-1, 1)
        sv = (sv * keep).reshape(nmb, 26, _S)
        sl = (sl * keep).reshape(nmb, 26, _S)
        cm = coded[:, None, None]
        sval = (torch.cat([hv[:, None], sv], 1) * cm).reshape(-1, _S)
        slen = (torch.cat([hl[:, None], sl], 1) * cm).reshape(-1, _S)
        words, bits, overflow = pack_windows(sval, slen, nmb, wwords)

        # ---- exact reconstruction: the next reference ----
        dz = (zz_l * blk_coded[..., None])[..., tb["unzz"]]
        d_l = (dz.reshape(mbh, mbw, 4, 4, 4, 4) * vy_m) << (qp // 6)
        res_l = (_itransform4(d_l) + 32) >> 6
        rec = torch.clamp(pred_y.reshape(mbh, mbw, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5) + res_l, 0, 255)
        ny = rec.permute(0, 2, 4, 1, 3, 5).reshape(Hl, Wl).to(torch.uint8)
        keep_dc = (cbp_chroma > 0) & coded.reshape(mbh, mbw)
        nplanes = []
        for ci_, predc in enumerate(pred_c):
            fdc = _had(tb["h2"], cdc_lv[ci_] * keep_dc[:, :, None, None])
            dcsc = ((fdc * v00c) << (qpc // 6)) >> 1
            zzc = torch.cat([torch.zeros(mbh, mbw, 2, 2, 1, dtype=_I32, device=device),
                             zz_cac[ci_] * keep_cac[:, :, None, None, None]], -1)
            d_c = (zzc[..., tb["unzz"]].reshape(mbh, mbw, 2, 2, 4, 4) * vc_m) << (qpc // 6)
            d_c[..., 0, 0] = dcsc
            res_c = (_itransform4(d_c) + 32) >> 6
            recc = torch.clamp(predc.reshape(mbh, mbw, 2, 4, 2, 4).permute(0, 1, 2, 4, 3, 5) + res_c, 0, 255)
            nplanes.append(recc.permute(0, 2, 4, 1, 3, 5).reshape(Hc, Wc).to(torch.uint8))
        return words, bits, overflow, ny, nplanes[0], nplanes[1]

    return encode


class InterEncoderDevice:
    """Device IDR + P encoder (ref ``InterEncoderTpu``, 1271-1380): P frames
    run as one chain of tensor operations on the device (motion search, MC,
    transforms, CAVLC, pack, exact reconstruction); IDR frames go through
    :class:`Intra16EncoderDevice`, and their reference picture is the shared
    C decoder's (``FastStreamDecoder``, sample-exact with the Python
    ``IntraDecoder`` the reference uses).  The reference picture ``ref``
    stays on the device between frames.

    Byte-equal to InterEncoderTpu at sizes that are whole macroblocks.  At
    other sizes the reference takes the IDR's picture as the decoder's
    cropped output, edge-padded again, where a decoder predicts from the
    decoded padding; motion into the padding then drifts its decoder away
    from its encoder (ROADMAP F5).  Here the IDR's slice is decoded under an
    SPS without cropping, so the reference picture is the decoder's whole
    one and every P frame decodes to ``ref`` exactly."""

    def __init__(self, width: int, height: int, qp: int = 26, gop: int = 30, search: int = 8,
                 wwords: int = 32, subpel: str = "half", device="cuda"):
        self.device = get_device(device) if not isinstance(device, torch.device) else device
        self.width, self.height = width, height
        self.qp, self.gop, self.search = qp, max(1, gop), search
        self.wwords = wwords
        self.subpel = subpel
        self.mb_w = (width + 15) // 16
        self.mb_h = (height + 15) // 16
        self.headers = H.make_sps(width, height, num_ref_frames=1) + H.make_pps(qp)
        # the same parameter sets without cropping: the IDR's whole picture
        self._uncropped = H.make_sps(self.mb_w * 16, self.mb_h * 16, num_ref_frames=1) + H.make_pps(qp)
        self._intra = Intra16EncoderDevice(width, height, qp, device=self.device)
        self._intra.headers = b""
        self._fns = {}
        self._idr_decoder = None
        self._frame_idx = 0
        self._frame_num = 0
        self.ref = None  # device (y, cb, cr) uint8, padded to whole macroblocks

    def _fn(self):
        fn = self._fns.get(self.wwords)
        if fn is None:
            fn = self._fns[self.wwords] = make_device_encode_p(
                self.width, self.height, self.qp, self.search, self.wwords, subpel=self.subpel,
                device=self.device)
        return fn

    def encode_uyvy(self, frame) -> bytes:
        """A UYVY frame (array, or tensor on the module's device) -> one
        access unit; the 4:2:0 split runs on the device."""
        return self._encode(*uyvy_to_planes(_frame_tensor(frame, self.device), self.width, self.height))

    def encode_planes(self, y, cb, cr) -> bytes:
        return self._encode(*_to_device_planes(y, cb, cr, self.device))

    def _encode(self, y, cb, cr) -> bytes:
        if self.ref is None or self._frame_idx % self.gop == 0:
            bs = self._encode_idr(y, cb, cr)
        else:
            bs = self._encode_p(y, cb, cr)
        self._frame_idx += 1
        return bs

    def _encode_idr(self, y, cb, cr) -> bytes:
        from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder

        if self._idr_decoder is None:
            self._idr_decoder = FastStreamDecoder()
        slice_ = self._intra._encode(y, cb, cr)
        got = self._idr_decoder.decode_au(self._uncropped + slice_)
        if got is None:
            raise RuntimeError("h264: the decoder returned no picture for an IDR access unit")
        self.ref = tuple(torch.as_tensor(p).to(self.device) for p in got)
        self._frame_num = 1
        return self.headers + slice_

    def _encode_p(self, y, cb, cr) -> bytes:
        args = (y, cb, cr) + tuple(self.ref)
        words, bits, ovf, ny, ncb, ncr = self._fn()(*args)
        while bool(ovf) and self.wwords < 1024:
            self.wwords *= 4  # one jump reaches intra-grade windows
            words, bits, ovf, ny, ncb, ncr = self._fn()(*args)
        self.ref = (ny, ncb, ncr)
        bs = self._assemble(_words_to_host(words), bits.cpu().numpy())
        self._frame_num = (self._frame_num + 1) & 15
        return bs

    def _assemble(self, wn: np.ndarray, bn: np.ndarray) -> bytes:
        hw = H.BitWriter()
        H._p_slice_header(hw, 0, self._frame_num)
        hval, hbits = _writer_bits(hw)
        # a trailing skip run when the frame ends in skips (the C assembler
        # appends the RBSP stop bit and padding itself)
        nmb = self.mb_w * self.mb_h
        coded_idx = np.flatnonzero(bn > 0)
        trailing = (nmb - 1 - coded_idx[-1]) if coded_idx.size else nmb
        tw = H.BitWriter()
        if trailing:
            tw.ue(int(trailing))
        tval, tbits = _writer_bits(tw)
        W = wn.shape[1]
        wn = np.concatenate([_bit_window(hval, hbits, W), wn, _bit_window(tval, tbits, W)])
        bn = np.concatenate([[hbits], bn, [tbits]])
        return b"\x00\x00\x00\x01" + bytes([(3 << 5) | 1]) + _assemble(wn, bn)  # non-IDR NAL
