"""CAVLC -> CABAC entropy transcode for the own H.264 encoder.

The TPU device encoder emits CAVLC bitstreams (the entropy backend that
packs on-device, ops/h264_tpu.py); CAVLC doubles as the symbol-transport
format, and this host stage re-encodes the *identical* syntax elements
with CABAC for ~10-15% smaller streams — the entropy-backend choice the
reference reaches through libx264's cabac flag
(src/video_compress/libavcodec.cpp:200-248).

Split of labor (the JPEG split-entropy recipe):
- Python rewrites the byte-/header-level containers: SPS profile 66->77
  (baseline forbids CABAC), PPS entropy_coding_mode_flag, slice headers
  (+ cabac_init_idc for P) + cabac_alignment_one_bit padding.
- native/h264_entropy.c h264fast_transcode_slice() walks the CAVLC MB
  layer and re-emits it through a spec-9.3.4 arithmetic encoder, with
  context derivations mirroring the sample-exact-validated CABAC decoder
  (ops/h264_cabac.py).  Pure syntax: no pixel reconstruction.

Correctness gate (tests/test_h264_transcode.py): the transcoded stream
decodes SAMPLE-EXACT to the CAVLC original through both the own decoder
and libavcodec.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from ultragrid_tpu_torch.ops.h264 import BitWriter, nal
from ultragrid_tpu_torch.ops.h264_dec import (BitReader, IntraDecoder,
                                        UnsupportedStream, split_nals_ref)

__all__ = ["transcode_au", "transcode_available", "cabac_headers"]


@lru_cache(maxsize=1)
def _handle():
    """Shared C handle carrying the serialized spec tables (one copy of
    every ISO constant; same source of truth as the fast decoder).  The
    transcode entry is not reentrant (longjmp error escape) — callers
    serialize, which the send pipeline does by construction."""
    from ultragrid_tpu_torch.native import h264_fast_lib
    from ultragrid_tpu_torch.ops.h264_fast import _vlc_blob

    lib = h264_fast_lib()
    if lib is None:
        return None
    from ultragrid_tpu_torch.ops.h264_8x8 import LAST8_INC, SIG8_INC
    from ultragrid_tpu_torch.ops.h264_cabac_tables import (CONTEXT_INIT,
                                                     RANGE_TAB_LPS,
                                                     TRANS_IDX_LPS)

    lib.h264fast_transcode_slice.restype = ctypes.c_long
    lib.h264fast_transcode_slice.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_long,
    ]
    blob = _vlc_blob()
    ctx = np.ascontiguousarray(np.asarray(CONTEXT_INIT, np.int8))
    rtab = np.ascontiguousarray(np.asarray(RANGE_TAB_LPS, np.int32))
    tlps = np.ascontiguousarray(np.asarray(TRANS_IDX_LPS, np.int32))
    sig8 = np.ascontiguousarray(np.asarray(SIG8_INC, np.int32))
    last8 = np.ascontiguousarray(np.asarray(LAST8_INC, np.int32))
    h = lib.h264fast_create(blob, len(blob), ctx.ctypes.data,
                            rtab.ctypes.data, tlps.ctypes.data,
                            sig8.ctypes.data, last8.ctypes.data)
    if not h:
        return None
    return lib, h


def transcode_available() -> bool:
    return _handle() is not None


def _patch_sps(rbsp: bytes) -> bytes:
    """Baseline (66) forbids CABAC: rewrite profile_idc to Main (77) with
    constraint_set1 (main-conformant).  Both fields are whole bytes at
    the head of the SPS RBSP, and 66/77 parse identically (7.3.2.1.1)."""
    if len(rbsp) < 3:
        raise UnsupportedStream("short SPS")
    profile = rbsp[0]
    if profile == 77:
        return rbsp
    if profile != 66:
        raise UnsupportedStream(f"transcode: profile {profile}")
    return bytes([77, 0x40]) + rbsp[2:]


def _reemit_pps(rbsp: bytes) -> bytes:
    """Re-emit the PPS with entropy_coding_mode_flag = 1 (CABAC)."""
    r = BitReader(rbsp)
    pps_id, sps_id = r.ue(), r.ue()
    cabac = r.u(1)
    bottom = r.u(1)
    slice_groups = r.ue()
    if slice_groups != 0:
        raise UnsupportedStream("transcode: slice groups")
    l0d, l1d = r.ue(), r.ue()
    wpred = r.u(1)
    wbipred = r.u(2)
    qp_d = r.se()
    qs_d = r.se()
    chroma_off = r.se()
    dbf, cip, rpc = r.u(1), r.u(1), r.u(1)
    if r.more_rbsp_data():
        raise UnsupportedStream("transcode: high-profile PPS tail")
    w = BitWriter()
    w.ue(pps_id)
    w.ue(sps_id)
    w.u(1, 1)          # entropy_coding_mode: CABAC
    w.u(bottom, 1)
    w.ue(slice_groups)
    w.ue(l0d)
    w.ue(l1d)
    w.u(wpred, 1)
    w.u(wbipred, 2)
    w.se(qp_d)
    w.se(qs_d)
    w.se(chroma_off)
    w.u(dbf, 1)
    w.u(cip, 1)
    w.u(rpc, 1)
    w.rbsp_trailing()
    del cabac
    return w.rbsp()


def _transcode_slice(rbsp: bytes, nal_type: int, ref_idc: int,
                     sps: dict, pps: dict, lib_h) -> bytes:
    """Parse the CAVLC slice header, re-emit it for CABAC, and run the C
    MB-layer transcode.  Returns the new slice RBSP."""
    lib, h = lib_h
    r = BitReader(rbsp)
    w = BitWriter()
    first_mb = r.ue()
    slice_type_raw = r.ue()
    st = slice_type_raw % 5      # 0 P, 2 I
    if st not in (0, 2):
        raise UnsupportedStream("transcode: only I/P slices")
    pps_id = r.ue()
    frame_num = r.u(sps["log2_mfn"])
    idr = nal_type == 5
    idr_pic_id = 0
    if idr:
        idr_pic_id = r.ue()
    poc_lsb = None
    if sps["poc_type"] == 0:
        poc_lsb = r.u(sps["log2_poc"])
    l0_active = pps["l0_default"]
    override = 0
    if st == 0:
        override = r.u(1)
        if override:
            l0_active = r.ue() + 1
        if r.u(1):
            raise UnsupportedStream("transcode: ref list modification")
        if pps.get("weighted_pred"):
            raise UnsupportedStream("transcode: weighted prediction")
    marking_bits = None
    if ref_idc != 0:
        if idr:
            marking_bits = (r.u(1), r.u(1))
        else:
            if r.u(1):
                raise UnsupportedStream("transcode: adaptive ref marking")
    slice_qp_delta = r.se()
    dbf_fields = None
    if pps["dbf_ctrl"]:
        idc = r.ue()
        if idc != 1:
            offa, offb = r.se(), r.se()
            dbf_fields = (idc, offa, offb)
        else:
            dbf_fields = (1,)
    slice_qp = pps["init_qp"] + slice_qp_delta

    # ---- re-emit the header with the CABAC additions ----
    w.ue(first_mb)
    w.ue(slice_type_raw)
    w.ue(pps_id)
    w.u(frame_num, sps["log2_mfn"])
    if idr:
        w.ue(idr_pic_id)
    if poc_lsb is not None:
        w.u(poc_lsb, sps["log2_poc"])
    if st == 0:
        w.u(override, 1)
        if override:
            w.ue(l0_active - 1)
        w.u(0, 1)       # ref_pic_list_modification_flag_l0
    if ref_idc != 0:
        if idr:
            w.u(marking_bits[0], 1)
            w.u(marking_bits[1], 1)
        else:
            w.u(0, 1)   # adaptive_ref_pic_marking_mode_flag
    if st == 0:
        w.ue(0)         # cabac_init_idc = 0
    w.se(slice_qp_delta)
    if dbf_fields is not None:
        w.ue(dbf_fields[0])
        if dbf_fields[0] != 1:
            w.se(dbf_fields[1])
            w.se(dbf_fields[2])
    # cabac_alignment_one_bit (7.3.4)
    while w.nbits % 8:
        w.u(1, 1)
    header = w.rbsp()

    data = np.frombuffer(rbsp, np.uint8)
    cap = len(rbsp) + 65536
    out = np.empty(cap, np.uint8)
    table_idx = 0 if st == 2 else 1   # cabac_init_idc 0 -> table 1
    n = lib.h264fast_transcode_slice(
        h, data.ctypes.data, data.size, r.pos, 0 if st == 0 else 2,
        slice_qp, first_mb, sps["mb_w"], sps["mb_h"], l0_active,
        table_idx, out.ctypes.data, cap)
    if n < 0:
        err = lib.h264fast_error(h)
        raise UnsupportedStream(
            (err or b"transcode failed").decode(errors="replace"))
    return header + out[:n].tobytes()


def transcode_au(au: bytes) -> bytes:
    """CAVLC access unit (Annex B, own-encoder envelope) -> CABAC AU.

    SPS/PPS in the AU are rewritten (and remembered for subsequent
    parameter-set-less AUs via the module-level cache on the caller —
    this function is stateless, so slice-only AUs must come through
    :func:`Transcoder`)."""
    return Transcoder().transcode_au(au)


def cabac_headers(headers: bytes) -> bytes:
    """Rewrite an SPS+PPS header blob for CABAC output."""
    out = []
    for nal_type, ref_idc, rbsp in split_nals_ref(headers):
        if nal_type == 7:
            out.append(nal(ref_idc, 7, _patch_sps(rbsp)))
        elif nal_type == 8:
            out.append(nal(ref_idc, 8, _reemit_pps(rbsp)))
        else:
            raise UnsupportedStream("transcode: non-parameter-set header")
    return b"".join(out)


class Transcoder:
    """Stateful AU transcoder: parameter sets seen once apply to later
    slice-only AUs (the own encoder repeats SPS/PPS on every IDR)."""

    def __init__(self) -> None:
        lh = _handle()
        if lh is None:
            raise UnsupportedStream("native transcoder unavailable")
        self._lh = lh
        self._sps = None
        self._pps = None
        self._dec = IntraDecoder()

    def transcode_au(self, au: bytes) -> bytes:
        out = []
        for nal_type, ref_idc, rbsp in split_nals_ref(au):
            if nal_type == 7:
                self._sps = self._dec._parse_sps(rbsp)
                out.append(nal(ref_idc, 7, _patch_sps(rbsp)))
            elif nal_type == 8:
                self._pps = self._dec._parse_pps(rbsp)
                if self._pps.get("cabac"):
                    raise UnsupportedStream("transcode: input already CABAC")
                out.append(nal(ref_idc, 8, _reemit_pps(rbsp)))
            elif nal_type in (1, 5):
                if self._sps is None or self._pps is None:
                    raise UnsupportedStream("transcode: slice before SPS/PPS")
                out.append(nal(ref_idc, nal_type, _transcode_slice(
                    rbsp, nal_type, ref_idc, self._sps, self._pps,
                    self._lh)))
            else:
                out.append(nal(ref_idc, nal_type, rbsp))
        return b"".join(out)
