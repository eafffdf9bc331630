"""From-scratch H.264/AVC baseline intra encoder (no FFmpeg dependency).

The reference's workhorse codec class wraps libavcodec/libx264
(ref: src/video_compress/libavcodec.cpp:200-248); this module is this
framework's OWN encoder for the same wire format: Annex-B H.264 with
SPS/PPS + IDR slices, decodable by any AVC decoder (conformance-tested
against libavcodec in tests/test_h264.py).

Two macroblock modes:

* ``I_PCM`` — raw samples, no prediction/transform (bit-exact, no
  compression; the spec's escape hatch).  Deblocking is disabled in the
  slice header so decoded output equals input exactly.
* ``I_16x16`` DC prediction + 4x4 integer transform + CAVLC — the real
  compressed mode (build-up in stages; see Intra16Encoder).

Design note (TPU-first): prediction uses SOURCE neighbors, not
reconstructed ones, which removes the sequential macroblock dependency so
transform/quant/CAVLC all parallelize over macroblocks (the same
slot-pack strategy as the JPEG encoder, ops/jpeg.py).  The bitstream stays
fully conformant — only the encoder-side prediction differs, introducing
bounded drift (≤ the neighbors' quantization error), a standard fast-
encoder trade.

Colour handling: baseline profile is 4:2:0; UYVY (4:2:2) input gets its
chroma rows pair-averaged.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# bit writing
# ---------------------------------------------------------------------------


class BitWriter:
    """MSB-first bit accumulator with RBSP trailing + emulation prevention."""

    def __init__(self):
        self.bytes = bytearray()
        self.acc = 0
        self.nbits = 0

    def u(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        self.acc = (self.acc << nbits) | (value & ((1 << nbits) - 1))
        self.nbits += nbits
        while self.nbits >= 8:
            self.nbits -= 8
            self.bytes.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def ue(self, value: int) -> None:
        """Exp-Golomb unsigned."""
        v = value + 1
        nbits = v.bit_length()
        self.u(0, nbits - 1)
        self.u(v, nbits)

    def se(self, value: int) -> None:
        """Exp-Golomb signed: 1,-1,2,-2,... -> 1,2,3,4,..."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    def byte_align_zero(self) -> None:
        if self.nbits:
            self.u(0, 8 - self.nbits)

    def rbsp_trailing(self) -> None:
        self.u(1, 1)
        self.byte_align_zero()

    def rbsp(self) -> bytes:
        assert self.nbits == 0, "call rbsp_trailing() first"
        return bytes(self.bytes)


def _ebsp(rbsp: bytes) -> bytes:
    """Insert emulation-prevention 0x03 bytes."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def nal(nal_ref_idc: int, nal_unit_type: int, rbsp: bytes, long_start: bool = True) -> bytes:
    start = b"\x00\x00\x00\x01" if long_start else b"\x00\x00\x01"
    hdr = bytes([(nal_ref_idc << 5) | nal_unit_type])
    return start + hdr + _ebsp(rbsp)


# ---------------------------------------------------------------------------
# parameter sets
# ---------------------------------------------------------------------------


def make_sps(width: int, height: int, level_idc: int = 51,
             num_ref_frames: int = 0) -> bytes:
    """Baseline-profile SPS for a progressive 4:2:0 frame."""
    mb_w = (width + 15) // 16
    mb_h = (height + 15) // 16
    crop_r = (mb_w * 16 - width) // 2   # in chroma samples (SubWidthC=2)
    crop_b = (mb_h * 16 - height) // 2
    w = BitWriter()
    w.u(66, 8)     # profile_idc: baseline
    w.u(0xC0, 8)   # constraint_set0/1 + reserved
    w.u(level_idc, 8)
    w.ue(0)        # sps_id
    w.ue(0)        # log2_max_frame_num_minus4
    w.ue(2)        # pic_order_cnt_type = 2 (display order = decode order)
    w.ue(num_ref_frames)  # max_num_ref_frames (1 for inter GOPs)
    w.u(0, 1)      # gaps_in_frame_num_value_allowed
    w.ue(mb_w - 1)
    w.ue(mb_h - 1)
    w.u(1, 1)      # frame_mbs_only_flag
    w.u(1, 1)      # direct_8x8_inference
    if crop_r or crop_b:
        w.u(1, 1)
        w.ue(0)
        w.ue(crop_r)
        w.ue(0)
        w.ue(crop_b)
    else:
        w.u(0, 1)
    w.u(0, 1)      # vui_parameters_present
    w.rbsp_trailing()
    return nal(3, 7, w.rbsp())


def make_pps(init_qp: int = 26) -> bytes:
    w = BitWriter()
    w.ue(0)        # pps_id
    w.ue(0)        # sps_id
    w.u(0, 1)      # entropy_coding_mode: CAVLC
    w.u(0, 1)      # bottom_field_pic_order_in_frame_present
    w.ue(0)        # num_slice_groups_minus1
    w.ue(0)        # num_ref_idx_l0_default_active_minus1
    w.ue(0)        # num_ref_idx_l1_default_active_minus1
    w.u(0, 1)      # weighted_pred_flag
    w.u(0, 2)      # weighted_bipred_idc
    w.se(init_qp - 26)  # pic_init_qp_minus26
    w.se(0)        # pic_init_qs_minus26
    w.se(0)        # chroma_qp_index_offset
    w.u(1, 1)      # deblocking_filter_control_present
    w.u(0, 1)      # constrained_intra_pred
    w.u(0, 1)      # redundant_pic_cnt_present
    w.rbsp_trailing()
    return nal(3, 8, w.rbsp())


def _slice_header(w: BitWriter, first_mb: int, idr_pic_id: int, qp_delta_base: int,
                  disable_deblock: bool, slice_qp_delta: int = 0) -> None:
    w.ue(first_mb)     # first_mb_in_slice
    w.ue(7)            # slice_type: I (all slices in pic)
    w.ue(0)            # pps_id
    w.u(0, 4)          # frame_num (log2_max_frame_num = 4)
    w.ue(idr_pic_id)   # idr_pic_id
    # dec_ref_pic_marking (IDR, nal_ref_idc != 0):
    w.u(0, 1)          # no_output_of_prior_pics_flag
    w.u(0, 1)          # long_term_reference_flag
    w.se(slice_qp_delta)  # slice_qp_delta
    if disable_deblock:
        w.ue(1)        # disable_deblocking_filter_idc = 1
    else:
        w.ue(0)
        w.se(0)
        w.se(0)


# ---------------------------------------------------------------------------
# planes
# ---------------------------------------------------------------------------


def uyvy_to_i420(frame: np.ndarray, width: int, height: int):
    """UYVY [H, 2W] -> (Y [H,W], Cb [H/2,W/2], Cr [H/2,W/2]) with
    pair-averaged chroma rows (baseline is 4:2:0)."""
    a = np.asarray(frame, np.uint8)[:height, : 2 * width]
    if height & 1:
        a = np.concatenate([a, a[-1:]], axis=0)
    y = a[:height, 1::2]
    cb = a[:, 0::4].astype(np.uint16)
    cr = a[:, 2::4].astype(np.uint16)
    cb = ((cb[0::2] + cb[1::2] + 1) >> 1).astype(np.uint8)
    cr = ((cr[0::2] + cr[1::2] + 1) >> 1).astype(np.uint8)
    return y, cb, cr


def _pad_to_mb(y, cb, cr):
    """Edge-pad planes to multiples of 16 (luma) / 8 (chroma)."""
    h, w = y.shape
    ph = (h + 15) & ~15
    pw = (w + 15) & ~15
    y = np.pad(y, ((0, ph - h), (0, pw - w)), mode="edge")
    ch, cw = cb.shape
    pch, pcw = ph // 2, pw // 2
    cb = np.pad(cb, ((0, pch - ch), (0, pcw - cw)), mode="edge")
    cr = np.pad(cr, ((0, pch - ch), (0, pcw - cw)), mode="edge")
    return y, cb, cr


# ---------------------------------------------------------------------------
# I_PCM encoder (stage A: conformant, lossless, no compression)
# ---------------------------------------------------------------------------


class PcmEncoder:
    """Every macroblock I_PCM: decodable by any AVC decoder, output is
    bit-exact input (deblocking disabled).  ~1.0x size; exists as the
    always-correct fallback and the conformance baseline for the real
    Intra16Encoder."""

    def __init__(self, width: int, height: int):
        self.width, self.height = width, height
        self.mb_w = (width + 15) // 16
        self.mb_h = (height + 15) // 16
        self.headers = make_sps(width, height) + make_pps()

    def encode_planes(self, y, cb, cr) -> bytes:
        y, cb, cr = _pad_to_mb(y, cb, cr)
        w = BitWriter()
        _slice_header(w, 0, 0, 0, disable_deblock=True)
        for my in range(self.mb_h):
            for mx in range(self.mb_w):
                w.ue(25)  # mb_type I_PCM
                w.byte_align_zero()  # pcm_alignment_zero_bit
                yb = y[my * 16 : my * 16 + 16, mx * 16 : mx * 16 + 16]
                for row in yb:
                    for v in row:
                        w.u(int(v), 8)
                for plane in (cb, cr):
                    pb = plane[my * 8 : my * 8 + 8, mx * 8 : mx * 8 + 8]
                    for row in pb:
                        for v in row:
                            w.u(int(v), 8)
        w.rbsp_trailing()
        return self.headers + nal(3, 5, w.rbsp())

    def encode_uyvy(self, frame: np.ndarray) -> bytes:
        y, cb, cr = uyvy_to_i420(frame, self.width, self.height)
        return self.encode_planes(y, cb, cr)


# ---------------------------------------------------------------------------
# CAVLC tables (ITU-T H.264 spec tables 9-5, 9-7, 9-8, 9-9, 9-10 — standard
# constants, reproduced from the published specification)
# ---------------------------------------------------------------------------


def _tab(spec: str):
    """'t1,tc:bits t1,tc:bits ...' -> {(t1,tc): (val,len)}"""
    out = {}
    for item in spec.split():
        key, _, bits = item.partition(":")
        a, _, b = key.partition(",")
        out[(int(a), int(b))] = (int(bits, 2), len(bits))
    return out


# coeff_token, 0 <= nC < 2
_CT0 = _tab("""
0,0:1
0,1:000101 1,1:01
0,2:00000111 1,2:000100 2,2:001
0,3:000000111 1,3:00000110 2,3:0000101 3,3:00011
0,4:0000000111 1,4:000000110 2,4:00000101 3,4:000011
0,5:00000000111 1,5:0000000110 2,5:000000101 3,5:0000100
0,6:0000000001111 1,6:00000000110 2,6:0000000101 3,6:00000100
0,7:0000000001011 1,7:0000000001110 2,7:00000000101 3,7:000000100
0,8:0000000001000 1,8:0000000001010 2,8:0000000001101 3,8:0000000100
0,9:00000000001111 1,9:00000000001110 2,9:0000000001001 3,9:00000000100
0,10:00000000001011 1,10:00000000001010 2,10:00000000001101 3,10:0000000001100
0,11:000000000001111 1,11:000000000001110 2,11:00000000001001 3,11:00000000001100
0,12:000000000001011 1,12:000000000001010 2,12:000000000001101 3,12:00000000001000
0,13:0000000000001111 1,13:000000000000001 2,13:000000000001001 3,13:000000000001100
0,14:0000000000001011 1,14:0000000000001110 2,14:0000000000001101 3,14:000000000001000
0,15:0000000000000111 1,15:0000000000001010 2,15:0000000000001001 3,15:0000000000001100
0,16:0000000000000100 1,16:0000000000000110 2,16:0000000000000101 3,16:0000000000001000
""")

# coeff_token, 2 <= nC < 4
_CT2 = _tab("""
0,0:11
0,1:001011 1,1:10
0,2:000111 1,2:00111 2,2:011
0,3:0000111 1,3:001010 2,3:001001 3,3:0101
0,4:00000111 1,4:000110 2,4:000101 3,4:0100
0,5:00000100 1,5:0000110 2,5:0000101 3,5:00110
0,6:000000111 1,6:00000110 2,6:00000101 3,6:001000
0,7:00000001111 1,7:000000110 2,7:000000101 3,7:000100
0,8:00000001011 1,8:00000001110 2,8:00000001101 3,8:0000100
0,9:000000001111 1,9:00000001010 2,9:00000001001 3,9:000000100
0,10:000000001011 1,10:000000001110 2,10:000000001101 3,10:00000001100
0,11:000000001000 1,11:000000001010 2,11:000000001001 3,11:00000001000
0,12:0000000001111 1,12:0000000001110 2,12:0000000001101 3,12:000000001100
0,13:0000000001011 1,13:0000000001010 2,13:0000000001001 3,13:0000000001100
0,14:0000000000111 1,14:00000000001011 2,14:0000000000110 3,14:0000000001000
0,15:00000000001001 1,15:00000000001000 2,15:00000000001010 3,15:0000000000001
0,16:00000000000111 1,16:00000000000110 2,16:00000000000101 3,16:00000000000100
""")

# coeff_token, 4 <= nC < 8
_CT4 = _tab("""
0,0:1111
0,1:001111 1,1:1110
0,2:001011 1,2:01111 2,2:1101
0,3:001000 1,3:01100 2,3:01110 3,3:1100
0,4:0001111 1,4:01010 2,4:01011 3,4:1011
0,5:0001011 1,5:01000 2,5:01001 3,5:1010
0,6:0001001 1,6:001110 2,6:001101 3,6:1001
0,7:0001000 1,7:001010 2,7:001001 3,7:1000
0,8:00001111 1,8:0001110 2,8:0001101 3,8:01101
0,9:00001011 1,9:00001110 2,9:0001010 3,9:001100
0,10:000001111 1,10:00001010 2,10:00001101 3,10:0001100
0,11:000001011 1,11:000001110 2,11:00001001 3,11:00001100
0,12:000001000 1,12:000001010 2,12:000001101 3,12:00001000
0,13:0000001101 1,13:000000111 2,13:000001001 3,13:000001100
0,14:0000001001 1,14:0000001100 2,14:0000001011 3,14:0000001010
0,15:0000000101 1,15:0000001000 2,15:0000000111 3,15:0000000110
0,16:0000000001 1,16:0000000100 2,16:0000000011 3,16:0000000010
""")

# coeff_token, chroma DC (nC == -1)
_CTC = _tab("""
0,0:01
0,1:000111 1,1:1
0,2:000100 1,2:000110 2,2:001
0,3:000011 1,3:0000011 2,3:0000010 3,3:000101
0,4:000010 1,4:00000011 2,4:00000010 3,4:0000000
""")


def _tz_tab(spec: str):
    out = {}
    for row in spec.strip().split("\n"):
        tc_s, _, rest = row.partition(":")
        out[int(tc_s)] = {
            i: (int(b, 2), len(b)) for i, b in enumerate(rest.split())
        }
    return out


# total_zeros for 4x4 blocks (tables 9-7/9-8), row = TotalCoeff, cols = tz 0..
_TZ = _tz_tab("""
1:1 011 010 0011 0010 00011 00010 000011 000010 0000011 0000010 00000011 00000010 000000011 000000010 000000001
2:111 110 101 100 011 0101 0100 0011 0010 00011 00010 000011 000010 000001 000000
3:0101 111 110 101 0100 0011 100 011 0010 00011 00010 000001 00001 000000
4:00011 111 0101 0100 110 101 100 0011 011 0010 00010 00001 00000
5:0101 0100 0011 111 110 101 100 011 0010 00001 0001 00000
6:000001 00001 111 110 101 100 011 010 0001 001 000000
7:000001 00001 101 100 011 11 010 0001 001 000000
8:000001 0001 00001 011 11 10 010 001 000000
9:000001 000000 0001 11 10 001 01 00001
10:00001 00000 001 11 10 01 0001
11:0000 0001 001 010 1 011
12:0000 0001 01 1 001
13:000 001 1 01
14:00 01 1
15:0 1
""")

# total_zeros, chroma DC (table 9-9b)
_TZC = _tz_tab("""
1:1 01 001 000
2:1 01 00
3:1 0
""")

# run_before (table 9-10): rows keyed by min(zerosLeft, 7)
_RB = _tz_tab("""
1:1 0
2:1 01 00
3:11 10 01 00
4:11 10 01 001 000
5:11 10 011 010 001 000
6:11 000 001 011 010 101 100
7:111 110 101 100 011 010 001 0001 00001 000001 0000001 00000001 000000001 0000000001 00000000001
""")

# 4x4 zigzag scan positions (r, c)
_ZZ4 = [(0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
        (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3), (3, 2), (3, 3)]

# 4x4 luma block coding order within an MB -> (bx, by) in 4-px units
_BLK_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
              (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]

# quant multiplier MF by QP%6 and coefficient class (a, b, c)
_MF = [
    (13107, 5243, 8066),
    (11916, 4660, 7490),
    (10082, 4194, 6554),
    (9362, 3647, 5825),
    (8192, 3355, 5243),
    (7282, 2893, 4559),
]
# class per raster position: a for (even,even) corners, b for (odd,odd), c else
_POSCLASS = [[0 if (r % 2 == 0 and c % 2 == 0) else 1 if (r % 2 and c % 2) else 2
              for c in range(4)] for r in range(4)]


def cavlc_block(w: "BitWriter", coeffs, nC: int) -> int:
    """CAVLC-encode one zigzag-ordered coefficient list.  Returns TotalCoeff.

    ``coeffs``: the block's coefficients already in zigzag order (16 for DC
    4x4 / full blocks, 15 for AC-only, 4 for chroma DC).  ``nC``: context
    (-1 for chroma DC).
    """
    n = len(coeffs)
    nz = [(i, int(c)) for i, c in enumerate(coeffs) if c]
    total = len(nz)
    # trailing ones: up to 3 |1| values at the end of the nonzero list
    t1 = 0
    for i in range(len(nz) - 1, -1, -1):
        if abs(nz[i][1]) == 1 and t1 < 3:
            t1 += 1
        else:
            break
    if nC == -1:
        table = _CTC
    elif nC < 2:
        table = _CT0
    elif nC < 4:
        table = _CT2
    elif nC < 8:
        table = _CT4
    else:
        table = None
    if table is not None:
        val, ln = table[(t1, total)]
        w.u(val, ln)
    else:  # 6-bit FLC
        if total == 0:
            w.u(3, 6)
        else:
            w.u(((total - 1) << 2) | t1, 6)
    if total == 0:
        return 0
    # trailing one signs (reverse order; 0 = +)
    for i in range(len(nz) - 1, len(nz) - 1 - t1, -1):
        w.u(0 if nz[i][1] > 0 else 1, 1)
    # remaining levels, reverse order
    suffix_len = 1 if (total > 10 and t1 < 3) else 0
    first = True
    for i in range(len(nz) - 1 - t1, -1, -1):
        level = nz[i][1]
        code = 2 * abs(level) - 2 if level > 0 else 2 * abs(level) - 1
        if first and t1 < 3:
            code -= 2
        first = False
        if suffix_len == 0:
            if code < 14:
                w.u(1, code + 1)           # code zeros then 1
            elif code < 30:
                w.u(1, 15)                 # prefix 14
                w.u(code - 14, 4)
            else:
                w.u(1, 16)                 # prefix 15
                w.u(code - 30, 12)
        else:
            if (code >> suffix_len) < 15:
                w.u(1, (code >> suffix_len) + 1)
                w.u(code & ((1 << suffix_len) - 1), suffix_len)
            else:
                w.u(1, 16)
                w.u(code - (15 << suffix_len), 12)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    # total_zeros
    zeros = nz[-1][0] + 1 - total
    if total < n:
        tz_tab = _TZC if nC == -1 else _TZ
        val, ln = tz_tab[total][zeros]
        w.u(val, ln)
    # run_before
    zeros_left = zeros
    for k in range(len(nz) - 1, 0, -1):
        if zeros_left <= 0:
            break
        run = nz[k][0] - nz[k - 1][0] - 1
        val, ln = _RB[min(zeros_left, 7)][run]
        w.u(val, ln)
        zeros_left -= run
    return total


# ---------------------------------------------------------------------------
# I_16x16 encoder (stage B: DC prediction + 4x4 transform + CAVLC)
# ---------------------------------------------------------------------------

_C4 = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]],
               np.int32)
_H4 = np.array([[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]],
               np.int32)
_H2 = np.array([[1, 1], [1, -1]], np.int32)


def _fwd4(block: np.ndarray) -> np.ndarray:
    return _C4 @ block.astype(np.int32) @ _C4.T


def _quant(coef: np.ndarray, qp: int) -> np.ndarray:
    """4x4 AC/full quant: sign(c) * ((|c|*MF + f) >> qbits)."""
    qbits = 15 + qp // 6
    mfr = _MF[qp % 6]
    mf = np.array([[mfr[_POSCLASS[r][c]] for c in range(4)] for r in range(4)],
                  np.int64)
    f = (1 << qbits) // 3
    lv = (np.abs(coef.astype(np.int64)) * mf + f) >> qbits
    return (np.sign(coef) * lv).astype(np.int32)


def _quant_dc(coef: np.ndarray, qp: int) -> np.ndarray:
    """Hadamard-domain DC quant: MF[0][0], double f, qbits+1."""
    qbits = 15 + qp // 6
    mf0 = _MF[qp % 6][0]
    f = (1 << qbits) // 3
    lv = (np.abs(coef.astype(np.int64)) * mf0 + 2 * f) >> (qbits + 1)
    return (np.sign(coef) * lv).astype(np.int32)


def _zigzag16(block: np.ndarray):
    return [int(block[r][c]) for r, c in _ZZ4]


_CHROMA_QP = [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38,
              38, 38, 39, 39, 39, 39]  # index qp-30 for qp in 30..51


def chroma_qp(qp: int) -> int:
    return qp if qp < 30 else _CHROMA_QP[qp - 30]


class Intra16Encoder:
    """All-I_16x16-DC encoder: real compression, bitstream-conformant
    (decoded by libavcodec in tests; PSNR-gated).  QP is fixed per frame.

    Prediction uses SOURCE neighbors (parallel-friendly; see module
    docstring).  CBP/nC bookkeeping follows the decoder's rules so CAVLC
    contexts match exactly.
    """

    def __init__(self, width: int, height: int, qp: int = 26,
                 deblock: bool = False):
        self.width, self.height = width, height
        self.qp = qp
        # deblock=True signals disable_deblocking_filter_idc=0: the DECODER
        # runs the 8.7 loop filter (better output quality, especially at
        # high QP).  Intra reconstruction/prediction is unaffected (8.3
        # predicts from unfiltered samples), so the encoder loop is
        # unchanged -- only the slice-header signal flips.
        self.deblock = deblock
        self.mb_w = (width + 15) // 16
        self.mb_h = (height + 15) // 16
        self.headers = make_sps(width, height) + make_pps(qp)

    # -- per-macroblock helpers -----------------------------------------

    def _pred_dc_luma(self, y, mx, my):
        left = y[my * 16 : my * 16 + 16, mx * 16 - 1] if mx > 0 else None
        top = y[my * 16 - 1, mx * 16 : mx * 16 + 16] if my > 0 else None
        if left is not None and top is not None:
            return (int(left.sum()) + int(top.sum()) + 16) >> 5
        if left is not None:
            return (int(left.sum()) + 8) >> 4
        if top is not None:
            return (int(top.sum()) + 8) >> 4
        return 128

    def _pred_dc_chroma4(self, p, mx, my, bx, by):
        """Chroma DC prediction per 4x4 sub-block (spec 8.3.4.1 DC rules)."""
        x0, y0 = mx * 8 + bx * 4, my * 8 + by * 4
        left = p[y0 : y0 + 4, mx * 8 - 1] if mx > 0 else None
        top = p[my * 8 - 1, x0 : x0 + 4] if my > 0 else None
        use_left = left is not None
        use_top = top is not None
        if bx == 1 and by == 0:
            use_left = False   # (1,0): top only (fall back to left)
            if top is None:
                use_left = left is not None
        if bx == 0 and by == 1:
            use_top = False    # (0,1): left only (fall back to top)
            if left is None:
                use_top = top is not None
        if use_left and use_top:
            return (int(left.sum()) + int(top.sum()) + 4) >> 3
        if use_left:
            return (int(left.sum()) + 2) >> 2
        if use_top:
            return (int(top.sum()) + 2) >> 2
        return 128

    # -- frame encode ----------------------------------------------------

    def encode_planes(self, y, cb, cr) -> bytes:
        y, cb, cr = _pad_to_mb(y, cb, cr)
        qp = self.qp
        qpc = chroma_qp(qp)
        mbw, mbh = self.mb_w, self.mb_h
        w = BitWriter()
        _slice_header(w, 0, 0, 0,
                      disable_deblock=not getattr(self, "deblock", False))
        # per-4x4 nonzero counts for nC prediction: luma [mbh*4, mbw*4],
        # chroma per component [mbh*2, mbw*2]
        nnz_l = np.zeros((mbh * 4, mbw * 4), np.int32)
        nnz_c = [np.zeros((mbh * 2, mbw * 2), np.int32) for _ in range(2)]

        def nc_of(nn, bx, by, left_avail, top_avail):
            na = nn[by, bx - 1] if left_avail else None
            nb = nn[by - 1, bx] if top_avail else None
            if na is not None and nb is not None:
                return (int(na) + int(nb) + 1) >> 1
            if na is not None:
                return int(na)
            if nb is not None:
                return int(nb)
            return 0

        for my in range(mbh):
            for mx in range(mbw):
                # ---- luma: predict, transform, quantize ----
                pred = self._pred_dc_luma(y, mx, my)
                res = y[my * 16 : my * 16 + 16, mx * 16 : mx * 16 + 16].astype(np.int32) - pred
                coefs = np.zeros((4, 4, 4, 4), np.int64)  # [by, bx, r, c]
                for by in range(4):
                    for bx in range(4):
                        coefs[by, bx] = _fwd4(res[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4])
                dc_raw = coefs[:, :, 0, 0].astype(np.int64)
                # JM convention: forward Hadamard halved, then the DC quant's
                # (qbits+1) shift absorbs the remaining transform gain
                dc_had = (_H4 @ dc_raw @ _H4) // 2
                dc_lv = _quant_dc(dc_had, qp)
                ac_lv = np.zeros((4, 4, 4, 4), np.int32)
                for by in range(4):
                    for bx in range(4):
                        q = _quant(coefs[by, bx], qp)
                        q[0, 0] = 0
                        ac_lv[by, bx] = q
                cbp_luma = 1 if np.any(ac_lv) else 0

                # ---- chroma ----
                cpred = np.zeros((2, 8, 8), np.int32)
                for ci, plane in enumerate((cb, cr)):
                    for by in range(2):
                        for bx in range(2):
                            cpred[ci, by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = \
                                self._pred_dc_chroma4(plane, mx, my, bx, by)
                cres = [
                    plane[my * 8 : my * 8 + 8, mx * 8 : mx * 8 + 8].astype(np.int32)
                    - cpred[ci]
                    for ci, plane in enumerate((cb, cr))
                ]
                cdc_lv = []
                cac_lv = []
                for ci in range(2):
                    cc = np.zeros((2, 2, 4, 4), np.int64)
                    for by in range(2):
                        for bx in range(2):
                            cc[by, bx] = _fwd4(cres[ci][by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4])
                    dc2 = _H2 @ cc[:, :, 0, 0] @ _H2
                    cdc_lv.append(_quant_dc(dc2, qpc))
                    acs = np.zeros((2, 2, 4, 4), np.int32)
                    for by in range(2):
                        for bx in range(2):
                            q = _quant(cc[by, bx], qpc)
                            q[0, 0] = 0
                            acs[by, bx] = q
                    cac_lv.append(acs)
                any_cac = any(np.any(a) for a in cac_lv)
                any_cdc = any(np.any(d) for d in cdc_lv)
                cbp_chroma = 2 if any_cac else (1 if any_cdc else 0)

                # ---- write macroblock ----
                mb_type = 1 + 2 + 4 * cbp_chroma + 12 * cbp_luma  # pred mode DC=2
                w.ue(mb_type)
                w.ue(0)  # intra_chroma_pred_mode: DC
                w.se(0)  # mb_qp_delta
                left_mb = mx > 0
                top_mb = my > 0
                # luma DC block: nC from blk(0,0) neighbors
                nc = nc_of(nnz_l, mx * 4, my * 4, left_mb, top_mb)
                cavlc_block(w, _zigzag16(dc_lv), nc)
                # luma AC blocks
                if cbp_luma:
                    for bi, (bx, by) in enumerate(_BLK_ORDER):
                        gx, gy = mx * 4 + bx, my * 4 + by
                        la = (gx % 4 > 0) or left_mb
                        ta = (gy % 4 > 0) or top_mb
                        nc = nc_of(nnz_l, gx, gy, la, ta)
                        zz = _zigzag16(ac_lv[by, bx])[1:]
                        tc = cavlc_block(w, zz, nc)
                        nnz_l[gy, gx] = tc
                # chroma DC (both components) when cbp_chroma > 0
                if cbp_chroma:
                    for ci in range(2):
                        d = cdc_lv[ci]
                        w_coefs = [int(d[0, 0]), int(d[0, 1]), int(d[1, 0]), int(d[1, 1])]
                        cavlc_block(w, w_coefs, -1)
                if cbp_chroma == 2:
                    for ci in range(2):
                        for by in range(2):
                            for bx in range(2):
                                gx, gy = mx * 2 + bx, my * 2 + by
                                la = (gx % 2 > 0) or left_mb
                                ta = (gy % 2 > 0) or top_mb
                                nc = nc_of(nnz_c[ci], gx, gy, la, ta)
                                zz = _zigzag16(cac_lv[ci][by, bx])[1:]
                                tc = cavlc_block(w, zz, nc)
                                nnz_c[ci][gy, gx] = tc
        w.rbsp_trailing()
        return self.headers + nal(3, 5, w.rbsp())

    def encode_uyvy(self, frame: np.ndarray) -> bytes:
        y, cb, cr = uyvy_to_i420(frame, self.width, self.height)
        return self.encode_planes(y, cb, cr)


# coded_block_pattern me(v) intra mapping, codeNum -> cbp (spec Table 9-4;
# the decoder holds the same list as ops/h264_dec.py:_CBP_INTRA — consistency
# is asserted in tests/test_h264.py)
_CBP_INTRA_TAB = [
    47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
    16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4,
    8, 17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41,
]
_CBP_INTRA_FWD = {cbp: i for i, cbp in enumerate(_CBP_INTRA_TAB)}


class Intra4x4Encoder(Intra16Encoder):
    """I_NxN (Intra_4x4) encoder: per-4x4 directional prediction (all nine
    spec modes, SAD + mode-bit-cost decision) with full 16-coefficient
    CAVLC blocks — better compression than I_16x16 DC on directional
    content at the same QP.

    Unlike the base class, luma prediction here reads RECONSTRUCTED
    neighbours (the decoder's own dequant/itransform is reused, so encoder
    and decoder reconstructions are bit-equal and there is no drift): at
    4x4 granularity the source-neighbour trade compounds V/H copy errors
    across whole block chains, which is unacceptable above low QPs.  The
    recurrence makes this the quality-first host path; the real-time
    device path stays I_16x16 (mode=i16).  Reference role: the I_4x4 side
    of libx264's intra analysis (src/video_compress/libavcodec.cpp wraps
    it).
    """

    def encode_planes(self, y, cb, cr) -> bytes:
        # decoder internals for exact in-loop reconstruction (runtime import:
        # h264_dec imports this module at load, so a top-level import cycles)
        from ultragrid_tpu_torch.ops.h264_dec import (_dezigzag, _itransform4,
                                                _pred4x4, _vmat)

        y, cb, cr = _pad_to_mb(y, cb, cr)
        qp = self.qp
        qpc = chroma_qp(qp)
        vy = _vmat(qp)
        mbw, mbh = self.mb_w, self.mb_h
        w = BitWriter()
        _slice_header(w, 0, 0, 0,
                      disable_deblock=not getattr(self, "deblock", False))
        nnz_l = np.zeros((mbh * 4, mbw * 4), np.int32)
        nnz_c = [np.zeros((mbh * 2, mbw * 2), np.int32) for _ in range(2)]
        i4mode = np.full((mbh * 4, mbw * 4), -1, np.int32)  # -1 = unavailable
        yr = np.zeros_like(y, np.int64)  # reconstructed luma (decoder-equal)
        done4 = np.zeros((mbh * 4, mbw * 4), bool)  # decode-order causality

        def nc_of(nn, bx, by, left_avail, top_avail):
            na = nn[by, bx - 1] if left_avail else None
            nb = nn[by - 1, bx] if top_avail else None
            if na is not None and nb is not None:
                return (int(na) + int(nb) + 1) >> 1
            if na is not None:
                return int(na)
            if nb is not None:
                return int(nb)
            return 0

        for my in range(mbh):
            for mx in range(mbw):
                left_mb = mx > 0
                top_mb = my > 0
                # ---- luma: per-4x4 mode decision + transform/quant ----
                modes = np.zeros(16, np.int32)
                zzs: list = [None] * 16
                counts = np.zeros(16, np.int32)
                for bi, (bx, by) in enumerate(_BLK_ORDER):
                    gx, gy = mx * 4 + bx, my * 4 + by
                    px, py = gx * 4, gy * 4
                    blk = y[py : py + 4, px : px + 4].astype(np.int64)
                    # neighbour samples exactly as the decoder's
                    # luma_neighbors(): availability follows decode order
                    t8 = None
                    if gy > 0 and done4[gy - 1, gx]:
                        t8 = np.empty(8, np.int64)
                        t8[:4] = yr[py - 1, px : px + 4]
                        if gx + 1 < mbw * 4 and done4[gy - 1, gx + 1]:
                            t8[4:] = yr[py - 1, px + 4 : px + 8]
                        else:
                            t8[4:] = yr[py - 1, px + 3]
                    left = (yr[py : py + 4, px - 1].astype(np.int64)
                            if gx > 0 and done4[gy, gx - 1] else None)
                    tl = (int(yr[py - 1, px - 1])
                          if t8 is not None and left is not None else None)
                    avail = [2]
                    if t8 is not None:
                        avail += [0, 3, 7]
                    if left is not None:
                        avail += [1, 8]
                    if t8 is not None and left is not None and tl is not None:
                        avail += [4, 5, 6]
                    cands = [(m, _pred4x4(m, t8, left, tl)) for m in avail]
                    ma = int(i4mode[gy, gx - 1]) if gx > 0 else -1
                    mb_ = int(i4mode[gy - 1, gx]) if gy > 0 else -1
                    pm = 2 if (ma < 0 or mb_ < 0) else min(ma, mb_)
                    best = None
                    for mode, pred in cands:
                        sad = int(np.abs(blk - pred).sum())
                        cost = sad + (0 if mode == pm else qp)  # 1 vs 4 bits
                        if best is None or cost < best[0]:
                            best = (cost, mode, pred)
                    _, mode, pred = best
                    modes[bi] = mode
                    i4mode[gy, gx] = mode
                    zz = _zigzag16(_quant(_fwd4(blk - pred), qp))
                    zzs[bi] = zz
                    counts[bi] = int(np.count_nonzero(zz))
                    # reconstruct exactly as the decoder (residual4 semantics)
                    d = _dezigzag(np.asarray(zz, np.int64)) * vy << (qp // 6)
                    res = (_itransform4(d) + 32) >> 6
                    yr[py : py + 4, px : px + 4] = np.clip(pred + res, 0, 255)
                    done4[gy, gx] = True
                cbp_luma = 0
                for g in range(4):
                    if counts[4 * g : 4 * g + 4].any():
                        cbp_luma |= 1 << g

                # ---- chroma (same DC-pred scheme as I_16x16) ----
                cdc_lv = []
                cac_lv = []
                for ci, plane in enumerate((cb, cr)):
                    cpred = np.zeros((8, 8), np.int32)
                    for by in range(2):
                        for bx in range(2):
                            cpred[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4] = \
                                self._pred_dc_chroma4(plane, mx, my, bx, by)
                    cres = plane[my * 8 : my * 8 + 8, mx * 8 : mx * 8 + 8].astype(np.int32) - cpred
                    cc = np.zeros((2, 2, 4, 4), np.int64)
                    for by in range(2):
                        for bx in range(2):
                            cc[by, bx] = _fwd4(cres[by * 4 : by * 4 + 4, bx * 4 : bx * 4 + 4])
                    cdc_lv.append(_quant_dc(_H2 @ cc[:, :, 0, 0] @ _H2, qpc))
                    acs = np.zeros((2, 2, 4, 4), np.int32)
                    for by in range(2):
                        for bx in range(2):
                            q = _quant(cc[by, bx], qpc)
                            q[0, 0] = 0
                            acs[by, bx] = q
                    cac_lv.append(acs)
                any_cac = any(np.any(a) for a in cac_lv)
                any_cdc = any(np.any(d) for d in cdc_lv)
                cbp_chroma = 2 if any_cac else (1 if any_cdc else 0)
                cbp = cbp_luma | (cbp_chroma << 4)

                # ---- write macroblock (syntax mirrored by h264_dec.py) ----
                w.ue(0)  # mb_type I_NxN
                for bi, (bx, by) in enumerate(_BLK_ORDER):
                    gx, gy = mx * 4 + bx, my * 4 + by
                    ma = int(i4mode[gy, gx - 1]) if gx > 0 else -1
                    # within this MB all modes are set; above-row from prior MBs
                    mb_ = int(i4mode[gy - 1, gx]) if gy > 0 else -1
                    pm = 2 if (ma < 0 or mb_ < 0) else min(ma, mb_)
                    mode = int(modes[bi])
                    if mode == pm:
                        w.u(1, 1)  # prev_intra4x4_pred_mode_flag
                    else:
                        w.u(0, 1)
                        w.u(mode if mode < pm else mode - 1, 3)
                w.ue(0)  # intra_chroma_pred_mode: DC
                w.ue(_CBP_INTRA_FWD[cbp])
                if cbp:
                    w.se(0)  # mb_qp_delta
                for bi, (bx, by) in enumerate(_BLK_ORDER):
                    gx, gy = mx * 4 + bx, my * 4 + by
                    if not (cbp_luma & (1 << (bi // 4))):
                        nnz_l[gy, gx] = 0
                        continue
                    la = (gx % 4 > 0) or left_mb
                    ta = (gy % 4 > 0) or top_mb
                    nc = nc_of(nnz_l, gx, gy, la, ta)
                    tc = cavlc_block(w, zzs[bi], nc)
                    nnz_l[gy, gx] = tc
                if cbp_chroma:
                    for ci in range(2):
                        d = cdc_lv[ci]
                        cavlc_block(
                            w, [int(d[0, 0]), int(d[0, 1]), int(d[1, 0]), int(d[1, 1])], -1)
                if cbp_chroma == 2:
                    for ci in range(2):
                        for by in range(2):
                            for bx in range(2):
                                gx, gy = mx * 2 + bx, my * 2 + by
                                la = (gx % 2 > 0) or left_mb
                                ta = (gy % 2 > 0) or top_mb
                                nc = nc_of(nnz_c[ci], gx, gy, la, ta)
                                zz = _zigzag16(cac_lv[ci][by, bx])[1:]
                                tc = cavlc_block(w, zz, nc)
                                nnz_c[ci][gy, gx] = tc
        w.rbsp_trailing()
        return self.headers + nal(3, 5, w.rbsp())


# ---------------------------------------------------------------------------
# Stage C: vectorized encoder (whole-frame numpy; device-mappable layout)
# ---------------------------------------------------------------------------
#
# Every entropy element becomes a (value, length) symbol in a FIXED slot
# grid per macroblock; absent elements get length 0.  The stream is then the
# flat slot sequence packed MSB-first — the identical strategy to the JPEG
# encoder's slot machinery (ops/jpeg.py), so the device port is mechanical.
# Per-block slot layout (36 slots):
#   [0] coeff_token | [1..3] trailing-one signs (rank 0..2)
#   [4..19] level of rank r at slot 4+r | [20] total_zeros
#   [21..35] run_before of rank r at slot 21+r


def _ue_symbol(v):
    """ue(v) as (value, length) arrays."""
    v = np.asarray(v, np.int64)
    bl = np.int64(np.ceil(np.log2(v + 2)))  # bitlen(v+1)
    bl = np.where((v + 1) >= (1 << bl), bl + 1, bl)  # guard fp edge
    return v + 1, 2 * bl - 1


def _table_arrays(table, shape):
    """dict[(a,b)] -> (val, len) dense arrays of given shape."""
    val = np.zeros(shape, np.int64)
    ln = np.zeros(shape, np.int64)
    for (a, b), (v, l) in table.items():
        val[a, b] = v
        ln[a, b] = l
    return val, ln


_CT_VAL = {}
_CT_LEN = {}
for _k, _t in (("0", _CT0), ("2", _CT2), ("4", _CT4), ("c", _CTC)):
    _CT_VAL[_k], _CT_LEN[_k] = _table_arrays(_t, (4, 17))

_TZ_VAL = np.zeros((17, 16), np.int64)
_TZ_LEN = np.zeros((17, 16), np.int64)
for _tc, _row in _TZ.items():
    for _tz, (_v, _l) in _row.items():
        _TZ_VAL[_tc, _tz] = _v
        _TZ_LEN[_tc, _tz] = _l
_TZC_VAL = np.zeros((4, 4), np.int64)
_TZC_LEN = np.zeros((4, 4), np.int64)
for _tc, _row in _TZC.items():
    for _tz, (_v, _l) in _row.items():
        _TZC_VAL[_tc, _tz] = _v
        _TZC_LEN[_tc, _tz] = _l
_RB_VAL = np.zeros((8, 15), np.int64)
_RB_LEN = np.zeros((8, 15), np.int64)
for _zl, _row in _RB.items():
    for _r, (_v, _l) in _row.items():
        _RB_VAL[_zl, _r] = _v
        _RB_LEN[_zl, _r] = _l

_ZZ_IDX = np.array([r * 4 + c for r, c in _ZZ4])  # zigzag gather indices


def cavlc_blocks_vec(levels: np.ndarray, nC: np.ndarray, chroma_dc: bool = False):
    """Vectorized CAVLC for N blocks.

    levels: [N, L] coefficients ALREADY zigzag-ordered (L = 16, 15 or 4).
    nC: [N] contexts (>= 0; pass chroma_dc=True for the -1 table).
    Returns (sym_val [N, 36], sym_len [N, 36], total_coeff [N]).
    """
    n, L = levels.shape
    lv = levels.astype(np.int64)
    nzm = lv != 0
    total = nzm.sum(axis=1)
    idx = np.arange(L)
    # rank from end: number of nonzeros at strictly higher positions
    nz_after = (np.cumsum(nzm[:, ::-1], axis=1)[:, ::-1] - nzm).astype(np.int64)
    # trailing ones: nonzeros with |l|==1 after the last |l|>1 nonzero
    big = nzm & (np.abs(lv) > 1)
    # trailing ones = nonzeros strictly after the LAST |level|>1 position
    # (all nonzeros when no big level exists)
    lastbig = np.where(big, idx, -1).max(axis=1)
    t1_raw = np.where(lastbig >= 0,
                      nz_after[np.arange(n), np.clip(lastbig, 0, L - 1)],
                      total)
    t1 = np.minimum(t1_raw, 3)
    last_nz = np.where(nzm, idx, -1).max(axis=1)
    zeros = np.where(total > 0, last_nz + 1 - total, 0)

    S = 36
    sval = np.zeros((n, S), np.int64)
    slen = np.zeros((n, S), np.int64)

    # coeff_token
    if chroma_dc:
        sval[:, 0] = _CT_VAL["c"][t1, total]
        slen[:, 0] = _CT_LEN["c"][t1, total]
    else:
        for lo, hi, key in ((0, 2, "0"), (2, 4, "2"), (4, 8, "4")):
            m = (nC >= lo) & (nC < hi)
            sval[m, 0] = _CT_VAL[key][t1[m], total[m]]
            slen[m, 0] = _CT_LEN[key][t1[m], total[m]]
        m = nC >= 8
        if m.any():
            tv = np.where(total[m] == 0, 3, ((total[m] - 1) << 2) | t1[m])
            sval[m, 0] = tv
            slen[m, 0] = 6
    # per-rank gathers: position and level of the coeff with rank r from end
    # pos_of_rank[m, r] = zigzag index of that coeff
    pos_of_rank = np.full((n, L), -1, np.int64)
    rows, cols = np.nonzero(nzm)
    pos_of_rank[rows, nz_after[rows, cols]] = cols
    lvl_of_rank = np.zeros((n, L), np.int64)
    lvl_of_rank[rows, nz_after[rows, cols]] = lv[rows, cols]

    # trailing one signs (ranks 0..t1-1): slots 1..3
    for r in range(3):
        m = r < t1
        sval[m, 1 + r] = (lvl_of_rank[m, r] < 0).astype(np.int64)
        slen[m, 1 + r] = 1

    # levels for ranks t1..total-1, with per-block suffix_len adaptation
    suffix_len = np.where((total > 10) & (t1 < 3), 1, 0).astype(np.int64)
    first = np.ones(n, bool)
    for r in range(L):
        m = (r >= t1) & (r < total)
        if not m.any():
            continue
        level = lvl_of_rank[:, r]
        code = np.where(level > 0, 2 * np.abs(level) - 2, 2 * np.abs(level) - 1)
        code = np.where(m & first & (t1 < 3), code - 2, code)
        sl = suffix_len
        # regular: prefix p = code >> sl (when < 15 or sl==0&&code<14)
        p = code >> np.maximum(sl, 0)
        val = np.zeros(n, np.int64)
        ln = np.zeros(n, np.int64)
        # sl == 0 cases
        c0 = m & (sl == 0)
        val = np.where(c0 & (code < 14), 1, val)
        ln = np.where(c0 & (code < 14), code + 1, ln)
        esc14 = c0 & (code >= 14) & (code < 30)
        val = np.where(esc14, (1 << 4) | (code - 14), val)
        ln = np.where(esc14, 15 + 4, ln)
        esc15_0 = c0 & (code >= 30)
        val = np.where(esc15_0, (1 << 12) | (code - 30), val)
        ln = np.where(esc15_0, 16 + 12, ln)
        # sl > 0 cases
        c1 = m & (sl > 0)
        reg = c1 & (p < 15)
        val = np.where(reg, (1 << sl) | (code & ((1 << sl) - 1)), val)
        ln = np.where(reg, p + 1 + sl, ln)
        esc15 = c1 & (p >= 15)
        val = np.where(esc15, (1 << 12) | (code - (15 << sl)), val)
        ln = np.where(esc15, 16 + 12, ln)
        sval[:, 4 + r] = np.where(m, val, sval[:, 4 + r])
        slen[:, 4 + r] = np.where(m, ln, slen[:, 4 + r])
        # state update
        suffix_len = np.where(m & (suffix_len == 0), 1, suffix_len)
        grow = m & (np.abs(level) > (3 << np.maximum(suffix_len - 1, 0))) & (suffix_len < 6)
        suffix_len = np.where(grow, suffix_len + 1, suffix_len)
        first = first & ~m

    # total_zeros (when 0 < total < L)
    m = (total > 0) & (total < L)
    if chroma_dc:
        sval[m, 20] = _TZC_VAL[total[m], zeros[m]]
        slen[m, 20] = _TZC_LEN[total[m], zeros[m]]
    else:
        sval[m, 20] = _TZ_VAL[total[m], zeros[m]]
        slen[m, 20] = _TZ_LEN[total[m], zeros[m]]

    # run_before: rank r vs rank r+1, while zeros remain
    zeros_left = zeros.copy()
    for r in range(L - 1):
        m = (r <= total - 2) & (zeros_left > 0)
        if not m.any():
            continue
        run = np.where(m, pos_of_rank[:, r] - pos_of_rank[:, r + 1] - 1, 0)
        zl = np.minimum(zeros_left, 7)
        sval[m, 21 + r] = _RB_VAL[zl[m], run[m]]
        slen[m, 21 + r] = _RB_LEN[zl[m], run[m]]
        zeros_left = np.where(m, zeros_left - run, zeros_left)
    return sval, slen, total


def pack_symbols(vals: np.ndarray, lens: np.ndarray) -> Tuple[bytes, int]:
    """Pack a flat (value, length<=28) symbol stream MSB-first.

    Returns (bytes, total_bits).  Disjoint-bit contributions are OR-combined
    into big-endian u32 words (the JPEG slot-pack formulation, host-side)."""
    keep = lens > 0
    lens = lens[keep].astype(np.int64)
    vals = vals[keep]
    vals = vals.astype(np.uint64) & ((np.uint64(1) << lens.astype(np.uint64)) - np.uint64(1))
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    offs = ends - lens
    nwords = (total + 31) // 32 + 1
    words = np.zeros(nwords, np.uint32)
    t = (offs & 31).astype(np.uint64)
    w0 = (offs >> 5).astype(np.int64)
    d = t + lens.astype(np.uint64)
    spans = d > 32
    x0 = np.where(spans, vals >> np.where(spans, d - 32, 0),
                  vals << ((np.uint64(32) - d) & np.uint64(31)))
    x1 = np.where(spans, vals << np.where(spans, np.uint64(64) - d, 0), 0)
    np.bitwise_or.at(words, w0, x0.astype(np.uint32))
    np.bitwise_or.at(words, w0 + 1, x1.astype(np.uint32))
    data = words.astype(">u4").tobytes()[: (total + 7) // 8]
    return data, total


def _bits_to_symbols(w: "BitWriter"):
    """BitWriter contents -> list of (value, length<=24) symbols."""
    out = []
    for b in w.bytes:
        out.append((int(b), 8))
    if w.nbits:
        out.append((int(w.acc), int(w.nbits)))
    return out


class Intra16EncoderV:
    """Vectorized whole-frame Intra16 encoder — bit-identical to
    :class:`Intra16Encoder`, but all transforms/quant/CAVLC run as
    array ops over every macroblock at once (the layout the device port
    uses; cf. the JPEG encoder's slot machinery)."""

    def __init__(self, width: int, height: int, qp: int = 26, slices: int = 1,
                 deblock: bool = False):
        self.width, self.height = width, height
        self.qp = qp
        self.deblock = deblock
        self.slices = slices
        self.mb_w = (width + 15) // 16
        self.mb_h = (height + 15) // 16
        self.headers = make_sps(width, height) + make_pps(qp)

    def encode_planes(self, y, cb, cr) -> bytes:
        """One IDR access unit; ``slices`` horizontal bands, each an
        independent slice (slice boundaries reset intra prediction and
        CAVLC contexts, so a band encodes exactly like a standalone
        frame of its height — the property the mesh-sharded encoder
        exploits; cf. parallel/sharded_jpeg.py's restart alignment)."""
        y, cb, cr = _pad_to_mb(y, cb, cr)
        if self.slices <= 1:
            return self.headers + self._slice_nal(y, cb, cr, 0)
        mbh, mbw = self.mb_h, self.mb_w
        bounds = [round(i * mbh / self.slices) for i in range(self.slices + 1)]
        out = [self.headers]
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            if b0 == b1:
                continue
            out.append(self._slice_nal(
                y[b0 * 16 : b1 * 16], cb[b0 * 8 : b1 * 8], cr[b0 * 8 : b1 * 8],
                b0 * mbw))
        return b"".join(out)

    def _slice_nal(self, y, cb, cr, first_mb: int) -> bytes:
        qp, qpc = self.qp, chroma_qp(self.qp)
        mbw = self.mb_w
        mbh = y.shape[0] // 16
        nmb = mbw * mbh
        yi = y.astype(np.int64)

        # ---- luma DC prediction (source neighbors), vectorized ----
        right_edge = yi[:, 15::16]            # [H, mbw] column sums source
        bottom_edge = yi[15::16, :]           # [mbh, W]
        top_sum = np.zeros((mbh, mbw), np.int64)
        top_sum[1:] = bottom_edge[:-1].reshape(mbh - 1, mbw, 16).sum(axis=2)
        left_sum = np.zeros((mbh, mbw), np.int64)
        left_sum[:, 1:] = right_edge[:, :-1].reshape(mbh, 16, mbw - 1).sum(axis=1)
        has_t = np.zeros((mbh, mbw), bool); has_t[1:] = True
        has_l = np.zeros((mbh, mbw), bool); has_l[:, 1:] = True
        pred = np.where(
            has_t & has_l, (top_sum + left_sum + 16) >> 5,
            np.where(has_l, (left_sum + 8) >> 4,
                     np.where(has_t, (top_sum + 8) >> 4, 128)),
        )

        # ---- luma residual -> 4x4 transforms, batched ----
        blocks = yi.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)  # [mbh,mbw,16,16]
        res = blocks - pred[:, :, None, None]
        b44 = res.reshape(mbh, mbw, 4, 4, 4, 4).transpose(0, 1, 2, 4, 3, 5)
        # [mbh, mbw, by, bx, 4, 4]
        coefs = np.einsum("ij,...jk,lk->...il", _C4, b44, _C4)
        dc_raw = coefs[..., 0, 0]
        dc_had = np.einsum("ij,...jk,kl->...il", _H4, dc_raw, _H4) // 2
        dc_lv = _quant_dc(dc_had, qp)                      # [mbh,mbw,4,4]
        qbits = 15 + qp // 6
        mfr = _MF[qp % 6]
        mf = np.array([[mfr[_POSCLASS[r][c]] for c in range(4)] for r in range(4)], np.int64)
        f = (1 << qbits) // 3
        ac_lv = (np.sign(coefs) * ((np.abs(coefs) * mf + f) >> qbits)).astype(np.int64)
        ac_lv[..., 0, 0] = 0
        cbp_luma = np.any(ac_lv.reshape(mbh, mbw, -1) != 0, axis=2)  # [mbh,mbw]

        # ---- chroma ----
        cdc_lv = []
        cac_lv = []
        for plane in (cb, cr):
            p = plane.astype(np.int64)
            # per-4x4-quadrant edge sums
            tq = np.zeros((mbh, mbw, 2), np.int64)   # top sums per bx quadrant
            tq[1:] = p[7::8][:-1].reshape(mbh - 1, mbw, 2, 4).sum(axis=3)
            lq = np.zeros((mbh, mbw, 2), np.int64)   # left sums per by quadrant
            lq[:, 1:] = p[:, 7::8][:, :-1].reshape(mbh, 2, 4, mbw - 1).sum(axis=2).transpose(0, 2, 1)
            cpred = np.zeros((mbh, mbw, 2, 2), np.int64)  # [my,mx,by,bx]
            ht = has_t; hl = has_l
            # (0,0): both -> avg8; (1,0): top else left0; (0,1): left else top0
            cpred[:, :, 0, 0] = np.where(ht & hl, (tq[:, :, 0] + lq[:, :, 0] + 4) >> 3,
                                 np.where(hl, (lq[:, :, 0] + 2) >> 2,
                                          np.where(ht, (tq[:, :, 0] + 2) >> 2, 128)))
            cpred[:, :, 0, 1] = np.where(ht, (tq[:, :, 1] + 2) >> 2,
                                 np.where(hl, (lq[:, :, 0] + 2) >> 2, 128))
            cpred[:, :, 1, 0] = np.where(hl, (lq[:, :, 1] + 2) >> 2,
                                 np.where(ht, (tq[:, :, 0] + 2) >> 2, 128))
            cpred[:, :, 1, 1] = np.where(ht & hl, (tq[:, :, 1] + lq[:, :, 1] + 4) >> 3,
                                 np.where(hl, (lq[:, :, 1] + 2) >> 2,
                                          np.where(ht, (tq[:, :, 1] + 2) >> 2, 128)))
            cblocks = p.reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)
            cres = cblocks.reshape(mbh, mbw, 2, 4, 2, 4).transpose(0, 1, 2, 4, 3, 5)
            cres = cres - cpred[..., None, None]
            cc = np.einsum("ij,...jk,lk->...il", _C4, cres, _C4)
            dc2 = np.einsum("ij,...jk,kl->...il", _H2, cc[..., 0, 0], _H2)
            cdc_lv.append(_quant_dc(dc2, qpc))
            qbc = 15 + qpc // 6
            mfrc = _MF[qpc % 6]
            mfc = np.array([[mfrc[_POSCLASS[r][c]] for c in range(4)] for r in range(4)], np.int64)
            fc = (1 << qbc) // 3
            a = (np.sign(cc) * ((np.abs(cc) * mfc + fc) >> qbc)).astype(np.int64)
            a[..., 0, 0] = 0
            cac_lv.append(a)
        any_cac = (np.any(cac_lv[0].reshape(mbh, mbw, -1) != 0, axis=2)
                   | np.any(cac_lv[1].reshape(mbh, mbw, -1) != 0, axis=2))
        any_cdc = (np.any(cdc_lv[0].reshape(mbh, mbw, -1) != 0, axis=2)
                   | np.any(cdc_lv[1].reshape(mbh, mbw, -1) != 0, axis=2))
        cbp_chroma = np.where(any_cac, 2, np.where(any_cdc, 1, 0))

        # ---- totals / nnz maps for nC (decoder bookkeeping) ----
        # zigzag AC levels per luma 4x4 [mbh,mbw,4(by),4(bx),15]
        zz_ac = ac_lv.reshape(mbh, mbw, 4, 4, 16)[..., _ZZ_IDX][..., 1:]
        tot_l = (zz_ac != 0).sum(axis=4)                     # [mbh,mbw,by,bx]
        nnz_l = np.zeros((mbh * 4, mbw * 4), np.int64)
        nnz_l_grid = (tot_l * cbp_luma[:, :, None, None]).transpose(0, 2, 1, 3)
        nnz_l = nnz_l_grid.reshape(mbh * 4, mbw * 4)
        zz_cac = [a.reshape(mbh, mbw, 2, 2, 16)[..., _ZZ_IDX][..., 1:] for a in cac_lv]
        tot_c = [(z != 0).sum(axis=4) for z in zz_cac]
        nnz_c = [
            (t * (cbp_chroma == 2)[:, :, None, None]).transpose(0, 2, 1, 3).reshape(mbh * 2, mbw * 2)
        for t in tot_c]

        def nc_grid(nn, gh, gw):
            """nC per 4x4 grid position from stored neighbor counts."""
            na = np.full((gh, gw), -1, np.int64)
            na[:, 1:] = nn[:, :-1]
            nb = np.full((gh, gw), -1, np.int64)
            nb[1:] = nn[:-1]
            both = (na >= 0) & (nb >= 0)
            return np.where(both, (na + nb + 1) >> 1,
                            np.where(na >= 0, na, np.where(nb >= 0, nb, 0)))

        ncl = nc_grid(nnz_l, mbh * 4, mbw * 4)
        ncc = [nc_grid(nn, mbh * 2, mbw * 2) for nn in nnz_c]

        # ---- symbol grid ----
        S = 36
        NSL = 3 + S * (1 + 16 + 2 + 8)
        sval = np.zeros((nmb, NSL), np.int64)
        slen = np.zeros((nmb, NSL), np.int64)
        mb_type = 1 + 2 + 4 * cbp_chroma.reshape(-1) + 12 * cbp_luma.reshape(-1).astype(np.int64)
        v, l = _ue_symbol(mb_type)
        sval[:, 0], slen[:, 0] = v, l
        sval[:, 1], slen[:, 1] = 1, 1  # intra_chroma_pred_mode ue(0)
        sval[:, 2], slen[:, 2] = 1, 1  # mb_qp_delta se(0)
        # DC block
        zz_dc = dc_lv.reshape(mbh, mbw, 16)[..., _ZZ_IDX].reshape(nmb, 16)
        nc_dc = ncl[::4, ::4]
        dv, dl, _ = cavlc_blocks_vec(zz_dc, nc_dc.reshape(-1))
        sval[:, 3 : 3 + S], slen[:, 3 : 3 + S] = dv, dl
        # luma AC blocks, coding order
        for bi, (bx, by) in enumerate(_BLK_ORDER):
            lvls = zz_ac[:, :, by, bx].reshape(nmb, 15)
            ncb = ncl[by::4, bx::4].reshape(-1)
            av, al, _ = cavlc_blocks_vec(lvls, ncb)
            keep = cbp_luma.reshape(-1)
            base = 3 + S * (1 + bi)
            sval[:, base : base + S] = av * keep[:, None]
            slen[:, base : base + S] = al * keep[:, None]
        # chroma DC
        for ci in range(2):
            d = cdc_lv[ci].reshape(nmb, 4)  # raster [00,01,10,11]
            cvv, cll, _ = cavlc_blocks_vec(d, np.zeros(nmb, np.int64), chroma_dc=True)
            keep = (cbp_chroma.reshape(-1) > 0)
            base = 3 + S * (17 + ci)
            sval[:, base : base + S] = cvv * keep[:, None]
            slen[:, base : base + S] = cll * keep[:, None]
        # chroma AC
        for ci in range(2):
            for bi, (bx, by) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                lvls = zz_cac[ci][:, :, by, bx].reshape(nmb, 15)
                ncb = ncc[ci][by::2, bx::2].reshape(-1)
                av, al, _ = cavlc_blocks_vec(lvls, ncb)
                keep = (cbp_chroma.reshape(-1) == 2)
                base = 3 + S * (19 + ci * 4 + bi)
                sval[:, base : base + S] = av * keep[:, None]
                slen[:, base : base + S] = al * keep[:, None]

        # ---- assemble: slice header symbols + MB slots + stop bit ----
        hw = BitWriter()
        _slice_header(hw, first_mb, 0, 0,
                      disable_deblock=not getattr(self, "deblock", False))
        head = _bits_to_symbols(hw)
        flat_v = np.concatenate([np.array([v for v, _ in head], np.int64),
                                 sval.reshape(-1), np.array([1], np.int64)])
        flat_l = np.concatenate([np.array([l for _, l in head], np.int64),
                                 slen.reshape(-1), np.array([1], np.int64)])
        data, _total_bits = pack_symbols(flat_v, flat_l)
        # rbsp trailing: stop bit appended above; pack pads to a byte with 0s
        return nal(3, 5, data)

    def encode_uyvy(self, frame: np.ndarray) -> bytes:
        y, cb, cr = uyvy_to_i420(frame, self.width, self.height)
        return self.encode_planes(y, cb, cr)


# ---------------------------------------------------------------------------
# Inter (P-frame) encoder: IDR + P GOPs with P_Skip, P_L0_16x16 integer-pel
# motion, and I_16x16 fallback macroblocks.  Covers the inter-frame role the
# reference fills via libavcodec (src/video_compress/libavcodec.cpp) with a
# from-scratch codec; decoded by libavcodec (conformance-tested) and by
# ops/h264_dec.StreamDecoder.
# ---------------------------------------------------------------------------


# half-pel refine candidate order (shared by scalar and vectorized paths
# so their tie-breaking matches)
_HALF_OFFS = ((2, 0), (-2, 0), (0, 2), (0, -2),
              (2, 2), (2, -2), (-2, 2), (-2, -2))


def _p_slice_header(w: BitWriter, first_mb: int, frame_num: int,
                    slice_qp_delta: int = 0) -> None:
    """P slice header (spec 7.3.3; pic_order_cnt_type=2, one L0 ref,
    deblocking disabled like the I slices)."""
    w.ue(first_mb)
    w.ue(5)            # slice_type: P (all slices in pic)
    w.ue(0)            # pps_id
    w.u(frame_num & 15, 4)
    w.u(0, 1)          # num_ref_idx_active_override_flag
    w.u(0, 1)          # ref_pic_list_modification_flag_l0
    w.u(0, 1)          # adaptive_ref_pic_marking_mode_flag (sliding window)
    w.se(slice_qp_delta)
    w.ue(1)            # disable_deblocking_filter_idc = 1


class InterEncoder:
    """GOP encoder: IDR (I_16x16, via Intra16Encoder) every ``gop`` frames,
    P frames in between.  Motion is integer-pel 16x16 (diamond search,
    range ``search`` pels); reconstruction is exact (decoder transforms) so
    the prediction loop never drifts."""

    def __init__(self, width: int, height: int, qp: int = 26, gop: int = 30,
                 search: int = 8):
        self.width, self.height = width, height
        self.qp = qp
        self.gop = max(1, gop)
        self.search = search
        self.mb_w = (width + 15) // 16
        self.mb_h = (height + 15) // 16
        self.headers = make_sps(width, height, num_ref_frames=1) + make_pps(qp)
        self._intra = Intra16Encoder(width, height, qp)
        self._frame_idx = 0
        self._frame_num = 0
        self._idr_id = 0
        self.ref = None  # reconstructed (y, cb, cr) uint8

    # -- reconstruction helpers (decoder-exact) ---------------------------

    @staticmethod
    def _dequant_res(q_zz: np.ndarray, qp: int) -> np.ndarray:
        from ultragrid_tpu_torch.ops.h264_dec import _dezigzag, _itransform4, _vmat

        d = _dezigzag(np.asarray(q_zz, np.int64)) * _vmat(qp) << (qp // 6)
        return (_itransform4(d) + 32) >> 6

    # -- motion estimation -------------------------------------------------

    def _search_mv(self, src_mb, refp, px, py):
        """Integer-pel diamond search on luma SAD; returns (dx, dy) pels."""
        from ultragrid_tpu_torch.ops.h264_dec import MC_PAD

        def sad(dx, dy):
            x0, y0 = px + dx + MC_PAD, py + dy + MC_PAD
            blk = refp[y0:y0 + 16, x0:x0 + 16].astype(np.int32)
            return int(np.abs(src_mb - blk).sum())

        best, bx, by = sad(0, 0), 0, 0
        if self.search:
            step = 8
            while step >= 1:
                improved = True
                while improved:
                    improved = False
                    for dx, dy in ((step, 0), (-step, 0), (0, step), (0, -step)):
                        nx, ny = bx + dx, by + dy
                        if abs(nx) > self.search or abs(ny) > self.search:
                            continue
                        s = sad(nx, ny)
                        if s < best:
                            best, bx, by, improved = s, nx, ny, True
                step //= 2
        return bx, by

    # -- frame encode -------------------------------------------------------

    def encode_planes(self, y, cb, cr) -> bytes:
        if self.ref is None or self._frame_idx % self.gop == 0:
            bs = self._encode_idr(y, cb, cr)
        else:
            bs = self._encode_p(y, cb, cr)
        self._frame_idx += 1
        return bs

    def encode_uyvy(self, frame: np.ndarray) -> bytes:
        y, cb, cr = uyvy_to_i420(frame, self.width, self.height)
        return self.encode_planes(y, cb, cr)

    def _encode_idr(self, y, cb, cr) -> bytes:
        from ultragrid_tpu_torch.ops.h264_dec import IntraDecoder

        self._intra.headers = b""  # we prepend our own (num_ref_frames=1)
        slice_bytes = self._intra.encode_planes(y, cb, cr)
        bs = self.headers + slice_bytes
        # reference = what a decoder reconstructs (sample-exact own decoder)
        ry, rcb, rcr = IntraDecoder().decode(self.headers + slice_bytes)
        yp, cbp, crp = _pad_to_mb(ry, rcb, rcr)
        self.ref = (yp, cbp, crp)
        self._frame_num = 1  # IDR resets frame_num to 0; next ref is 1
        self._idr_id = (self._idr_id + 1) & 0xFFFF
        return bs

    def _encode_p(self, y, cb, cr) -> bytes:
        from ultragrid_tpu_torch.ops.h264_dec import (_CBP_INTER_FWD, half_planes,
                                                mc_chroma, mc_luma, mv_pred,
                                                pad_ref, skip_mv)

        y, cb, cr = _pad_to_mb(y, cb, cr)
        qp = self.qp
        qpc = chroma_qp(qp)
        mbw, mbh = self.mb_w, self.mb_h
        ry, rcb, rcr = self.ref
        rpy, rpcb, rpcr = pad_ref(ry), pad_ref(rcb), pad_ref(rcr)
        halfp = [None]  # lazily-built 6-tap half-sample planes
        # reconstruction planes for THIS frame (become the next reference)
        ny = np.zeros_like(ry, np.int64)
        ncb = np.zeros_like(rcb, np.int64)
        ncr = np.zeros_like(rcr, np.int64)

        w = BitWriter()
        _p_slice_header(w, 0, self._frame_num)
        nnz_l = np.zeros((mbh * 4, mbw * 4), np.int32)
        nnz_c = [np.zeros((mbh * 2, mbw * 2), np.int32) for _ in range(2)]
        mvs = np.zeros((mbh, mbw, 2), np.int64)
        refs = np.full((mbh, mbw), -1, np.int64)

        def nc_of(nn, bx, by, left_avail, top_avail):
            na = nn[by, bx - 1] if left_avail else None
            nb = nn[by - 1, bx] if top_avail else None
            if na is not None and nb is not None:
                return (int(na) + int(nb) + 1) >> 1
            if na is not None:
                return int(na)
            if nb is not None:
                return int(nb)
            return 0

        skip_run = 0
        for my in range(mbh):
            for mx in range(mbw):
                px, py = mx * 16, my * 16
                cx, cy = mx * 8, my * 8
                src_y = y[py:py + 16, px:px + 16].astype(np.int32)

                dx, dy = self._search_mv(src_y, rpy, px, py)
                mvx, mvy = dx * 4, dy * 4  # quarter-pel units
                pred_y = mc_luma(rpy, px, py, mvx, mvy)
                if self.search:
                    # half-pel refine: 8 neighbors at quarter-step 2
                    # (spec 8.4.2.2.1 6-tap samples via the shared planes)
                    if halfp[0] is None:
                        halfp[0] = half_planes(rpy)
                    best_sad = int(np.abs(src_y - pred_y).sum())
                    best_mv = (mvx, mvy)
                    for hdx, hdy in _HALF_OFFS:
                        cand = mc_luma(rpy, px, py, mvx + hdx, mvy + hdy,
                                       halfp=halfp[0])
                        sad = int(np.abs(src_y - cand).sum())
                        if sad < best_sad:
                            best_sad, pred_y = sad, cand
                            best_mv = (mvx + hdx, mvy + hdy)
                    mvx, mvy = best_mv
                pred_c = [mc_chroma(rpcb, cx, cy, mvx, mvy),
                          mc_chroma(rpcr, cx, cy, mvx, mvy)]

                # luma residual: 16 x LumaLevel4x4 (full 16-coeff blocks)
                res = src_y - pred_y
                q_l = np.zeros((4, 4, 16), np.int64)
                for by_ in range(4):
                    for bx_ in range(4):
                        c4 = _fwd4(res[by_ * 4:by_ * 4 + 4, bx_ * 4:bx_ * 4 + 4])
                        q_l[by_, bx_] = _zigzag16(_quant(c4, qp))
                cbp_luma = 0
                for g in range(4):
                    blocks = [q_l[(g // 2) * 2 + i, (g % 2) * 2 + j]
                              for i in range(2) for j in range(2)]
                    if any(np.any(b) for b in blocks):
                        cbp_luma |= 1 << g

                # chroma residual (DC 2x2 + AC), prediction from MC
                cres = [cb[cy:cy + 8, cx:cx + 8].astype(np.int64) - pred_c[0],
                        cr[cy:cy + 8, cx:cx + 8].astype(np.int64) - pred_c[1]]
                cdc_lv, cac_lv = [], []
                for ci in range(2):
                    cc = np.zeros((2, 2, 4, 4), np.int64)
                    for by_ in range(2):
                        for bx_ in range(2):
                            cc[by_, bx_] = _fwd4(
                                cres[ci][by_ * 4:by_ * 4 + 4, bx_ * 4:bx_ * 4 + 4])
                    dc2 = _H2 @ cc[:, :, 0, 0] @ _H2
                    cdc_lv.append(_quant_dc(dc2, qpc))
                    acs = np.zeros((2, 2, 4, 4), np.int64)
                    for by_ in range(2):
                        for bx_ in range(2):
                            q = _quant(cc[by_, bx_], qpc)
                            q[0, 0] = 0
                            acs[by_, bx_] = q
                    cac_lv.append(acs)
                any_cac = any(np.any(a) for a in cac_lv)
                any_cdc = any(np.any(d_) for d_ in cdc_lv)
                cbp_chroma = 2 if any_cac else (1 if any_cdc else 0)
                cbp = cbp_luma | (cbp_chroma << 4)

                smx, smy = skip_mv(mvs, refs, mx, my, mbw, 0)
                if cbp == 0 and (mvx, mvy) == (smx, smy):
                    skip_run += 1
                    mvs[my, mx] = (mvx, mvy)
                    refs[my, mx] = 0
                    self._recon_inter(ny, ncb, ncr, px, py, pred_y, pred_c,
                                      q_l, 0, cdc_lv, cac_lv, 0, qp, qpc)
                    nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                    for nn in nnz_c:
                        nn[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
                    continue

                w.ue(skip_run)
                skip_run = 0
                pmx, pmy = mv_pred(mvs, refs, mx, my, mbw, 0)
                w.ue(0)  # mb_type P_L0_16x16
                w.se(mvx - pmx)
                w.se(mvy - pmy)
                mvs[my, mx] = (mvx, mvy)
                refs[my, mx] = 0
                w.ue(_CBP_INTER_FWD[cbp])
                left_mb, top_mb = mx > 0, my > 0
                if cbp:
                    w.se(0)  # mb_qp_delta
                    for bi, (bx_, by_) in enumerate(_BLK_ORDER):
                        gx, gy = mx * 4 + bx_, my * 4 + by_
                        if cbp_luma & (1 << (bi // 4)):
                            la = (gx % 4 > 0) or left_mb
                            ta = (gy % 4 > 0) or top_mb
                            nc = nc_of(nnz_l, gx, gy, la, ta)
                            tc = cavlc_block(w, list(q_l[by_, bx_]), nc)
                            nnz_l[gy, gx] = tc
                        else:
                            nnz_l[gy, gx] = 0
                    self._write_chroma(w, cbp_chroma, cdc_lv, cac_lv,
                                       mx, my, left_mb, top_mb, nnz_c, nc_of)
                else:
                    nnz_l[my * 4:my * 4 + 4, mx * 4:mx * 4 + 4] = 0
                    for nn in nnz_c:
                        nn[my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0
                self._recon_inter(ny, ncb, ncr, px, py, pred_y, pred_c,
                                  q_l, cbp_luma, cdc_lv, cac_lv, cbp_chroma,
                                  qp, qpc)
        if skip_run:
            w.ue(skip_run)
        w.rbsp_trailing()
        self.ref = (ny.astype(np.uint8), ncb.astype(np.uint8),
                    ncr.astype(np.uint8))
        bs = nal(3, 1, w.rbsp())
        self._frame_num = (self._frame_num + 1) & 15
        return bs

    def _write_chroma(self, w, cbp_chroma, cdc_lv, cac_lv, mx, my,
                      left_mb, top_mb, nnz_c, nc_of):
        if cbp_chroma:
            for ci in range(2):
                d = cdc_lv[ci]
                cavlc_block(w, [int(d[0, 0]), int(d[0, 1]),
                                int(d[1, 0]), int(d[1, 1])], -1)
        if cbp_chroma == 2:
            for ci in range(2):
                for by_ in range(2):
                    for bx_ in range(2):
                        gx, gy = mx * 2 + bx_, my * 2 + by_
                        la = (gx % 2 > 0) or left_mb
                        ta = (gy % 2 > 0) or top_mb
                        nc = nc_of(nnz_c[ci], gx, gy, la, ta)
                        zz = _zigzag16(cac_lv[ci][by_, bx_])[1:]
                        tc = cavlc_block(w, zz, nc)
                        nnz_c[ci][gy, gx] = tc
        else:
            for ci in range(2):
                nnz_c[ci][my * 2:my * 2 + 2, mx * 2:mx * 2 + 2] = 0

    def _recon_inter(self, ny, ncb, ncr, px, py, pred_y, pred_c,
                     q_l, cbp_luma, cdc_lv, cac_lv, cbp_chroma, qp, qpc):
        """Decoder-exact reconstruction of one inter MB."""
        from ultragrid_tpu_torch.ops.h264_dec import (_dezigzag, _itransform4,
                                                _vmat)

        for by_ in range(4):
            for bx_ in range(4):
                bi = by_ * 4 + bx_  # group index derives from block coords
                g = (by_ // 2) * 2 + (bx_ // 2)
                if cbp_luma & (1 << g):
                    r4 = self._dequant_res(q_l[by_, bx_], qp)
                else:
                    r4 = 0
                ny[py + by_ * 4:py + by_ * 4 + 4,
                   px + bx_ * 4:px + bx_ * 4 + 4] = np.clip(
                    pred_y[by_ * 4:by_ * 4 + 4, bx_ * 4:bx_ * 4 + 4] + r4,
                    0, 255)
        cx, cy = px // 2, py // 2
        vc = _vmat(qpc)
        for ci, plane in enumerate((ncb, ncr)):
            if cbp_chroma:
                dcq = np.asarray(cdc_lv[ci], np.int64)
                fdc = _H2 @ dcq @ _H2
                dcsc = ((fdc * int(vc[0, 0])) << (qpc // 6)) >> 1
            else:
                dcsc = np.zeros((2, 2), np.int64)
            for by_ in range(2):
                for bx_ in range(2):
                    if cbp_chroma == 2:
                        zz = _zigzag16(cac_lv[ci][by_, bx_])
                    else:
                        zz = np.zeros(16, np.int64)
                    d = _dezigzag(np.asarray(zz, np.int64)) * vc << (qpc // 6)
                    d[0, 0] = dcsc[by_, bx_]
                    r4 = (_itransform4(d) + 32) >> 6
                    plane[cy + by_ * 4:cy + by_ * 4 + 4,
                          cx + bx_ * 4:cx + bx_ * 4 + 4] = np.clip(
                        pred_c[ci][by_ * 4:by_ * 4 + 4,
                                   bx_ * 4:bx_ * 4 + 4] + r4, 0, 255)


# ---------------------------------------------------------------------------
# Vectorized inter encoder: whole-frame array ops (the production path,
# mirroring Intra16EncoderV's slot machinery).  With search=0 it is
# bit-identical to InterEncoder; with search>0 it runs a coarse+refine
# full-search ME over fixed candidate grids (conformance-tested).
# ---------------------------------------------------------------------------


def _se_symbol(v):
    """se(v) as (value, length) arrays (signed Exp-Golomb)."""
    v = np.asarray(v, np.int64)
    cn = np.where(v > 0, 2 * v - 1, -2 * v)
    return _ue_symbol(cn)


def _ue_symbol2(v):
    """ue(v) split into (zeros, value) symbol pairs so lengths stay <= 28
    bits for arbitrarily large operands (whole-frame skip runs)."""
    v = np.asarray(v, np.int64)
    val, ln = _ue_symbol(v)
    bl = (ln + 1) // 2
    return (np.zeros_like(v), bl - 1), (val, bl)


def _itransform4_batch(d: np.ndarray) -> np.ndarray:
    """Batched spec 8.5.12.2 inverse core transform over [..., 4, 4]."""
    def pass1(x):
        x0, x1 = x[..., 0, :], x[..., 1, :]
        x2, x3 = x[..., 2, :], x[..., 3, :]
        e0 = x0 + x2
        e1 = x0 - x2
        e2 = (x1 >> 1) - x3
        e3 = x1 + (x3 >> 1)
        return np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=-2)

    h = np.swapaxes(pass1(np.swapaxes(d, -1, -2)), -1, -2)
    return pass1(h)


def _dezigzag_batch(zz: np.ndarray) -> np.ndarray:
    """[..., 16] zigzag -> [..., 4, 4]."""
    out = np.zeros(zz.shape, np.int64)
    out[..., _ZZ_IDX] = zz
    return out.reshape(zz.shape[:-1] + (4, 4))


class InterEncoderV(InterEncoder):
    """Whole-frame vectorized IDR+P encoder (see InterEncoder).  P-frame
    hot path is numpy array ops end to end: candidate-grid ME, gathered MC,
    batched transforms/quant, grid MV prediction/skip, vectorized CAVLC +
    slot packing, batched exact reconstruction."""

    def __init__(self, width: int, height: int, qp: int = 26, gop: int = 30,
                 search: int = 8):
        super().__init__(width, height, qp, gop, search)
        self._intra = Intra16EncoderV(width, height, qp)

    # -- vectorized ME ------------------------------------------------------

    def _me(self, y, rpy):
        """Per-MB integer (dx, dy): coarse step-2 full search + step-1
        refinement.  Returns int arrays [mbh, mbw]."""
        from ultragrid_tpu_torch.ops.h264_dec import MC_PAD

        mbh, mbw = self.mb_h, self.mb_w
        H_, W_ = mbh * 16, mbw * 16
        cur = y.astype(np.int32)
        if not self.search:
            return np.zeros((mbh, mbw), np.int64), np.zeros((mbh, mbw), np.int64)
        s = self.search
        best = np.full((mbh, mbw), 1 << 60, np.int64)
        bdx = np.zeros((mbh, mbw), np.int64)
        bdy = np.zeros((mbh, mbw), np.int64)
        cands = [(0, 0)] + [(dx, dy)
                            for dy in range(-s, s + 1, 2)
                            for dx in range(-s, s + 1, 2) if (dx, dy) != (0, 0)]
        for dx, dy in cands:
            ref = rpy[MC_PAD + dy:MC_PAD + dy + H_,
                      MC_PAD + dx:MC_PAD + dx + W_].astype(np.int32)
            sad = np.abs(cur - ref).reshape(mbh, 16, mbw, 16).sum(axis=(1, 3))
            # strict < keeps the earliest candidate on ties ((0,0) first)
            m = sad < best
            best = np.where(m, sad, best)
            bdx = np.where(m, dx, bdx)
            bdy = np.where(m, dy, bdy)
        # step-1 refinement around each MB's winner (gathered blocks)
        myg, mxg = np.mgrid[0:mbh, 0:mbw]
        r16 = np.arange(16)
        for ddx, ddy in ((1, 0), (-1, 0), (0, 1), (0, -1),
                         (1, 1), (1, -1), (-1, 1), (-1, -1)):
            ndx = np.clip(bdx + ddx, -s, s)
            ndy = np.clip(bdy + ddy, -s, s)
            ry_ = (myg * 16 + ndy)[:, :, None, None] + r16[None, None, :, None] + MC_PAD
            rx_ = (mxg * 16 + ndx)[:, :, None, None] + r16[None, None, None, :] + MC_PAD
            blocks = rpy[ry_, rx_].astype(np.int32)
            sad = np.abs(cur.reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)
                         - blocks).sum(axis=(2, 3))
            m = sad < best
            best = np.where(m, sad, best)
            bdx = np.where(m, ndx, bdx)
            bdy = np.where(m, ndy, bdy)
        return bdx, bdy

    # -- vectorized MV prediction / skip -------------------------------------

    @staticmethod
    def _mvp_grids(mvx, mvy):
        """Median MV predictor per MB over final MV grids (all refs == 0;
        spec 8.4.1.3, JM rule order).  Returns (pmx, pmy)."""
        mbh, mbw = mvx.shape

        def shifted(a, dx, dy, avail):
            """out[y, x] = a[y + dy, x + dx] where in range, else 0."""
            out = np.zeros_like(a)
            ys = slice(max(0, -dy), mbh - max(0, dy) or None)
            xs = slice(max(0, -dx), mbw - max(0, dx) or None)
            ys_s = slice(max(0, dy), mbh - max(0, -dy) or None)
            xs_s = slice(max(0, dx), mbw - max(0, -dx) or None)
            out[ys, xs] = a[ys_s, xs_s]
            return np.where(avail, out, 0)

        availA = np.zeros((mbh, mbw), bool); availA[:, 1:] = True
        availB = np.zeros((mbh, mbw), bool); availB[1:, :] = True
        availC = np.zeros((mbh, mbw), bool); availC[1:, :-1] = True
        availD = np.zeros((mbh, mbw), bool); availD[1:, 1:] = True
        useC = availC
        availCD = availC | availD
        out = []
        for a in (mvx, mvy):
            va = shifted(a, -1, 0, availA)
            vb = shifted(a, 0, -1, availB)
            vc = np.where(useC, shifted(a, 1, -1, availC),
                          shifted(a, -1, -1, availD))
            med = np.maximum(np.minimum(va, vb),
                             np.minimum(np.maximum(va, vb), vc))
            navail = (availA.astype(np.int64) + availB + availCD)
            only = np.where(availA, va, 0) + np.where(availB, vb, 0) \
                + np.where(availCD, vc, 0)
            pm = np.where(~availB & ~availCD & availA, va,
                          np.where(navail == 1, only, med))
            out.append(pm)
        return out[0], out[1]

    @staticmethod
    def _skip_mv_grids(mvx, mvy, pmx, pmy):
        """P_Skip MV per MB (spec 8.4.1.1) over final MV grids."""
        mbh, mbw = mvx.shape
        availA = np.zeros((mbh, mbw), bool); availA[:, 1:] = True
        availB = np.zeros((mbh, mbw), bool); availB[1:, :] = True
        za = np.zeros((mbh, mbw), bool)
        za[:, 1:] = (mvx[:, :-1] == 0) & (mvy[:, :-1] == 0)
        zb = np.zeros((mbh, mbw), bool)
        zb[1:, :] = (mvx[:-1, :] == 0) & (mvy[:-1, :] == 0)
        force0 = ~availA | ~availB | (availA & za) | (availB & zb)
        return np.where(force0, 0, pmx), np.where(force0, 0, pmy)

    # -- P frame -------------------------------------------------------------

    def _encode_p(self, y, cb, cr) -> bytes:
        from ultragrid_tpu_torch.ops.h264_dec import (MC_PAD, _CBP_INTER_FWD,
                                                _vmat, pad_ref)

        y, cb, cr = _pad_to_mb(y, cb, cr)
        qp, qpc = self.qp, chroma_qp(self.qp)
        mbh, mbw = self.mb_h, self.mb_w
        nmb = mbh * mbw
        ry, rcb, rcr = self.ref
        rpy, rpcb, rpcr = pad_ref(ry), pad_ref(rcb), pad_ref(rcr)

        dx, dy = self._me(y, rpy)
        mvx, mvy = dx * 4, dy * 4

        # ---- gathered luma MC prediction [mbh, mbw, 16, 16] ----
        myg, mxg = np.mgrid[0:mbh, 0:mbw]
        r16 = np.arange(16)
        gy = (myg * 16 + dy)[:, :, None, None] + r16[None, None, :, None] + MC_PAD
        gx = (mxg * 16 + dx)[:, :, None, None] + r16[None, None, None, :] + MC_PAD
        pred_y = rpy[gy, gx].astype(np.int64)
        cur = y.astype(np.int64).reshape(mbh, 16, mbw, 16).transpose(0, 2, 1, 3)

        if self.search:
            # vectorized half-pel refine over the shared 6-tap planes
            from ultragrid_tpu_torch.ops.h264_dec import half_planes

            bpl, hpl, jpl = half_planes(rpy)
            best_sad = np.abs(cur - pred_y).sum(axis=(2, 3))
            imvx, imvy = mvx, mvy  # fixed integer-pel base for candidates
            mvx, mvy = mvx.copy(), mvy.copy()
            for hdx, hdy in _HALF_OFFS:
                cmx, cmy = imvx + hdx, imvy + hdy
                ix, iy = cmx >> 2, cmy >> 2
                fx, fy = hdx & 3, hdy & 3  # 0 or 2, same for every MB
                if fx and fy:
                    plane, ox, oy = jpl, -2, -2
                elif fx:
                    plane, ox, oy = bpl, -2, 0
                else:
                    plane, ox, oy = hpl, 0, -2
                cgy = ((myg * 16 + iy + oy)[:, :, None, None]
                       + r16[None, None, :, None] + MC_PAD)
                cgx = ((mxg * 16 + ix + ox)[:, :, None, None]
                       + r16[None, None, None, :] + MC_PAD)
                cand = plane[cgy, cgx].astype(np.int64)
                sad = np.abs(cur - cand).sum(axis=(2, 3))
                m = sad < best_sad
                best_sad = np.where(m, sad, best_sad)
                mvx = np.where(m, cmx, mvx)
                mvy = np.where(m, cmy, mvy)
                pred_y = np.where(m[:, :, None, None], cand, pred_y)

        res = cur - pred_y

        # ---- chroma MC (eighth-sample bilinear, frac in {0, 4}) ----
        r8 = np.arange(8)
        cxi, cxf = mvx >> 3, mvx & 7
        cyi, cyf = mvy >> 3, mvy & 7
        cgy = (myg * 8 + cyi)[:, :, None, None] + r8[None, None, :, None] + MC_PAD
        cgx = (mxg * 8 + cxi)[:, :, None, None] + r8[None, None, None, :] + MC_PAD
        wxf = cxf[:, :, None, None]
        wyf = cyf[:, :, None, None]
        pred_c = []
        for plane in (rpcb, rpcr):
            a = plane[cgy, cgx].astype(np.int64)
            b = plane[cgy, cgx + 1].astype(np.int64)
            c_ = plane[cgy + 1, cgx].astype(np.int64)
            d_ = plane[cgy + 1, cgx + 1].astype(np.int64)
            pred_c.append(((8 - wxf) * (8 - wyf) * a + wxf * (8 - wyf) * b
                           + (8 - wxf) * wyf * c_ + wxf * wyf * d_ + 32) >> 6)

        # ---- luma residual: 16-coeff blocks, batched ----
        b44 = res.reshape(mbh, mbw, 4, 4, 4, 4).transpose(0, 1, 2, 4, 3, 5)
        coefs = np.einsum("ij,...jk,lk->...il", _C4, b44, _C4)
        qbits = 15 + qp // 6
        mfr = _MF[qp % 6]
        mf = np.array([[mfr[_POSCLASS[r][c]] for c in range(4)]
                       for r in range(4)], np.int64)
        f = (1 << qbits) // 3
        q_l = (np.sign(coefs) * ((np.abs(coefs) * mf + f) >> qbits)).astype(np.int64)
        zz_l = q_l.reshape(mbh, mbw, 4, 4, 16)[..., _ZZ_IDX]  # [.., by, bx, 16]
        grp_nz = np.zeros((mbh, mbw, 4), bool)  # 8x8 group has coefficients
        for by_ in range(4):
            for bx_ in range(4):
                g = (by_ // 2) * 2 + (bx_ // 2)
                grp_nz[:, :, g] |= np.any(zz_l[:, :, by_, bx_] != 0, axis=2)
        cbp_luma = (grp_nz[:, :, 0] * 1 + grp_nz[:, :, 1] * 2
                    + grp_nz[:, :, 2] * 4 + grp_nz[:, :, 3] * 8).astype(np.int64)

        # ---- chroma residual ----
        qbc = 15 + qpc // 6
        mfrc = _MF[qpc % 6]
        mfc = np.array([[mfrc[_POSCLASS[r][c]] for c in range(4)]
                        for r in range(4)], np.int64)
        fc = (1 << qbc) // 3
        cdc_lv, cac_lv = [], []
        for ci, plane in enumerate((cb, cr)):
            p = plane.astype(np.int64).reshape(mbh, 8, mbw, 8).transpose(0, 2, 1, 3)
            cres = p - pred_c[ci]
            c44 = cres.reshape(mbh, mbw, 2, 4, 2, 4).transpose(0, 1, 2, 4, 3, 5)
            cc = np.einsum("ij,...jk,lk->...il", _C4, c44, _C4)
            dc2 = np.einsum("ij,...jk,kl->...il", _H2, cc[..., 0, 0], _H2)
            cdc_lv.append(_quant_dc(dc2, qpc))
            a = (np.sign(cc) * ((np.abs(cc) * mfc + fc) >> qbc)).astype(np.int64)
            a[..., 0, 0] = 0
            cac_lv.append(a)
        any_cac = (np.any(cac_lv[0].reshape(mbh, mbw, -1) != 0, axis=2)
                   | np.any(cac_lv[1].reshape(mbh, mbw, -1) != 0, axis=2))
        any_cdc = (np.any(cdc_lv[0].reshape(mbh, mbw, -1) != 0, axis=2)
                   | np.any(cdc_lv[1].reshape(mbh, mbw, -1) != 0, axis=2))
        cbp_chroma = np.where(any_cac, 2, np.where(any_cdc, 1, 0)).astype(np.int64)
        cbp = cbp_luma | (cbp_chroma << 4)

        # ---- skip decisions over the final MV grids ----
        pmx, pmy = self._mvp_grids(mvx, mvy)
        smx, smy = self._skip_mv_grids(mvx, mvy, pmx, pmy)
        skip = (cbp == 0) & (mvx == smx) & (mvy == smy)
        coded = ~skip.reshape(-1)

        # skip_run before each coded MB + trailing run
        flat_idx = np.flatnonzero(coded)
        runs = np.diff(np.r_[-1, flat_idx]) - 1
        trailing = (nmb - 1 - flat_idx[-1]) if flat_idx.size else nmb

        # ---- nnz/nC bookkeeping (masked by coded groups) ----
        tot_l = (zz_l != 0).sum(axis=4)  # [mbh, mbw, by, bx]
        gidx = np.array([[(by_ // 2) * 2 + (bx_ // 2) for bx_ in range(4)]
                         for by_ in range(4)])
        blk_coded = grp_nz[:, :, gidx] & coded.reshape(mbh, mbw, 1, 1)
        nnz_l = (tot_l * blk_coded).transpose(0, 2, 1, 3).reshape(mbh * 4, mbw * 4)
        zz_cac = [a.reshape(mbh, mbw, 2, 2, 16)[..., _ZZ_IDX][..., 1:]
                  for a in cac_lv]
        keep_cac = (cbp_chroma == 2) & coded.reshape(mbh, mbw)
        nnz_c = [((z != 0).sum(axis=4) * keep_cac[:, :, None, None]
                  ).transpose(0, 2, 1, 3).reshape(mbh * 2, mbw * 2)
                 for z in zz_cac]

        def nc_grid(nn, gh, gw):
            na = np.full((gh, gw), -1, np.int64)
            na[:, 1:] = nn[:, :-1]
            nb = np.full((gh, gw), -1, np.int64)
            nb[1:] = nn[:-1]
            both = (na >= 0) & (nb >= 0)
            return np.where(both, (na + nb + 1) >> 1,
                            np.where(na >= 0, na, np.where(nb >= 0, nb, 0)))

        ncl = nc_grid(nnz_l, mbh * 4, mbw * 4)
        ncc = [nc_grid(nn, mbh * 2, mbw * 2) for nn in nnz_c]

        # ---- symbol grid ----
        S = 36
        NH = 8  # run(2) + mb_type + mvdx + mvdy + cbp(2) + qp_delta
        NSL = NH + S * (16 + 2 + 8)
        sval = np.zeros((nmb, NSL), np.int64)
        slen = np.zeros((nmb, NSL), np.int64)
        run_per_mb = np.zeros(nmb, np.int64)
        run_per_mb[flat_idx] = runs
        (rz_v, rz_l), (rv_v, rv_l) = _ue_symbol2(run_per_mb)
        sval[:, 0], slen[:, 0] = rz_v, rz_l
        sval[:, 1], slen[:, 1] = rv_v, rv_l
        sval[:, 2], slen[:, 2] = 1, 1  # mb_type ue(0) = P_L0_16x16
        mvd_x = (mvx - pmx).reshape(-1)
        mvd_y = (mvy - pmy).reshape(-1)
        v, l = _se_symbol(mvd_x)
        sval[:, 3], slen[:, 3] = v, l
        v, l = _se_symbol(mvd_y)
        sval[:, 4], slen[:, 4] = v, l
        cbp_code = np.array([_CBP_INTER_FWD[int(c)] for c in cbp.reshape(-1)],
                            np.int64)
        (cz_v, cz_l), (cv_v, cv_l) = _ue_symbol2(cbp_code)
        sval[:, 5], slen[:, 5] = cz_v, cz_l
        sval[:, 6], slen[:, 6] = cv_v, cv_l
        has_cbp = (cbp.reshape(-1) != 0)
        sval[:, 7], slen[:, 7] = 1, has_cbp.astype(np.int64)  # se(0) if cbp

        # residual slots: 16 luma blocks in coding order
        for bi, (bx_, by_) in enumerate(_BLK_ORDER):
            lvls = zz_l[:, :, by_, bx_].reshape(nmb, 16)
            ncb = ncl[by_::4, bx_::4].reshape(-1)
            av, al, _ = cavlc_blocks_vec(lvls, ncb)
            keep = blk_coded[:, :, by_, bx_].reshape(-1)
            base = NH + S * bi
            sval[:, base:base + S] = av * keep[:, None]
            slen[:, base:base + S] = al * keep[:, None]
        # chroma DC
        keep_cdc = (cbp_chroma.reshape(-1) > 0) & coded
        for ci in range(2):
            d = cdc_lv[ci].reshape(nmb, 4)
            cvv, cll, _ = cavlc_blocks_vec(d, np.zeros(nmb, np.int64),
                                           chroma_dc=True)
            base = NH + S * (16 + ci)
            sval[:, base:base + S] = cvv * keep_cdc[:, None]
            slen[:, base:base + S] = cll * keep_cdc[:, None]
        # chroma AC
        kac = keep_cac.reshape(-1)
        for ci in range(2):
            for bi, (bx_, by_) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
                lvls = zz_cac[ci][:, :, by_, bx_].reshape(nmb, 15)
                ncb = ncc[ci][by_::2, bx_::2].reshape(-1)
                av, al, _ = cavlc_blocks_vec(lvls, ncb)
                base = NH + S * (18 + ci * 4 + bi)
                sval[:, base:base + S] = av * kac[:, None]
                slen[:, base:base + S] = al * kac[:, None]

        # skipped MBs contribute nothing (their run rides the next coded MB)
        sval *= coded[:, None]
        slen *= coded[:, None]

        # ---- assemble ----
        hw = BitWriter()
        _p_slice_header(hw, 0, self._frame_num)
        head = _bits_to_symbols(hw)
        tail_v, tail_l = [], []
        if trailing:
            (tz_v, tz_l), (tv_v, tv_l) = _ue_symbol2(np.array([trailing]))
            tail_v += [int(tz_v[0]), int(tv_v[0])]
            tail_l += [int(tz_l[0]), int(tv_l[0])]
        tail_v.append(1)  # rbsp stop bit
        tail_l.append(1)
        flat_v = np.concatenate([np.array([v for v, _ in head], np.int64),
                                 sval.reshape(-1),
                                 np.array(tail_v, np.int64)])
        flat_l = np.concatenate([np.array([l for _, l in head], np.int64),
                                 slen.reshape(-1),
                                 np.array(tail_l, np.int64)])
        data, _bits = pack_symbols(flat_v, flat_l)
        bs = nal(3, 1, data)

        # ---- batched exact reconstruction -> next reference ----
        vmy = _vmat(qp)
        d_l = _dezigzag_batch(zz_l * blk_coded[..., None]) * vmy << (qp // 6)
        res_l = (_itransform4_batch(d_l) + 32) >> 6
        rec = np.clip(pred_y.reshape(mbh, mbw, 4, 4, 4, 4).transpose(
            0, 1, 2, 4, 3, 5) + res_l, 0, 255)
        ny = rec.transpose(0, 2, 4, 1, 3, 5).reshape(mbh * 16, mbw * 16)
        vmc = _vmat(qpc)
        keep_dc = ((cbp_chroma > 0) & coded.reshape(mbh, mbw))
        nplanes = []
        for ci in range(2):
            fdc = np.einsum("ij,...jk,kl->...il", _H2,
                            cdc_lv[ci] * keep_dc[:, :, None, None], _H2)
            dcsc = ((fdc * int(vmc[0, 0])) << (qpc // 6)) >> 1
            zzc = np.zeros((mbh, mbw, 2, 2, 16), np.int64)
            zzc[..., 1:] = zz_cac[ci] * keep_cac[:, :, None, None, None]
            d_c = _dezigzag_batch(zzc) * vmc << (qpc // 6)
            d_c[..., 0, 0] = dcsc
            res_c = (_itransform4_batch(d_c) + 32) >> 6
            recc = np.clip(pred_c[ci].reshape(mbh, mbw, 2, 4, 2, 4).transpose(
                0, 1, 2, 4, 3, 5) + res_c, 0, 255)
            nplanes.append(recc.transpose(0, 2, 4, 1, 3, 5).reshape(
                mbh * 8, mbw * 8))
        self.ref = (ny.astype(np.uint8), nplanes[0].astype(np.uint8),
                    nplanes[1].astype(np.uint8))
        self._frame_num = (self._frame_num + 1) & 15
        return bs
