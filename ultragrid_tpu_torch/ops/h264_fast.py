"""Real-time own-H.264 decode path: ctypes wrapper over the C entropy +
reconstruction stage (native/h264_entropy.c).

Same split as the JPEG receive path (native/jpeg_scan_decode.c): the
sequential bit-level work (CAVLC/CABAC parsing, intra prediction chains,
MC, deblock) runs in C at real-time rates; the scalar Python decoder
(:mod:`ops.h264_dec` / :mod:`ops.h264_cabac`) remains the readable
reference implementation.  Every stream the C decoder accepts must decode
SAMPLE-EXACTLY equal to the Python decoder — gated over the full
conformance matrix in tests/test_h264_fast.py, which itself pins the
Python decoder to libavcodec.

The ISO constant tables (CAVLC code tables, CABAC context init /
rangeTabLPS / transIdxLPS) are serialized HERE from their single source
of truth (ops/h264.py, ops/h264_cabac_tables.py) and passed to the C
library at create time — no second transcription exists in the repo.

Reference role: the decode half of
src/video_decompress/libavcodec.c:1-1876.
"""

from __future__ import annotations

import ctypes
import struct
from functools import lru_cache
from typing import Tuple

import numpy as np

from ultragrid_tpu_torch.native import h264_fast_lib
from ultragrid_tpu_torch.ops.h264_dec import UnsupportedStream


def _ser_table(tid: int, entries) -> bytes:
    """entries: iterable of (code_len, code_val, a, b)."""
    out = [struct.pack("<HH", tid, len(entries))]
    for ln, code, a, b in entries:
        out.append(struct.pack("<BHbb", ln, code, a, b))
    return b"".join(out)


@lru_cache(maxsize=1)
def _vlc_blob() -> bytes:
    """Serialize the CAVLC decode tables from the encoder's spec tables
    (ops/h264.py) — table ids must match native/h264_entropy.c."""
    from ultragrid_tpu_torch.ops import h264 as H

    blob = []
    # 0..3: coeff_token (t1, total) -> (val, len); decode needs (len, val)
    # -> (t1, total)
    for tid, tab in enumerate((H._CT0, H._CT2, H._CT4, H._CTC)):
        entries = [(ln, val, t1, total)
                   for (t1, total), (val, ln) in tab.items()]
        blob.append(_ser_table(tid, entries))
    # 4..18: total_zeros for total_coeff 1..15
    for tc in range(1, 16):
        entries = [(ln, val, tz, 0) for tz, (val, ln) in H._TZ[tc].items()]
        blob.append(_ser_table(3 + tc, entries))
    # 19..21: chroma-DC total_zeros for total_coeff 1..3
    for tc in range(1, 4):
        entries = [(ln, val, tz, 0) for tz, (val, ln) in H._TZC[tc].items()]
        blob.append(_ser_table(18 + tc, entries))
    # 22..28: run_before for zeros_left 1..7
    for zl in range(1, 8):
        entries = [(ln, val, run, 0) for run, (val, ln) in H._RB[zl].items()]
        blob.append(_ser_table(21 + zl, entries))
    return b"".join(blob)


def fast_available() -> bool:
    return h264_fast_lib() is not None


class FastStreamDecoder:
    """Stateful Annex-B decoder, drop-in for ops/h264_dec.StreamDecoder's
    decode_au/decode_stream surface, at C speed.  Raises
    :class:`UnsupportedStream` outside the envelope (same conditions as
    the Python decoder; the caller falls back to lavc)."""

    def __init__(self) -> None:
        self._lib = h264_fast_lib()
        if self._lib is None:
            raise UnsupportedStream("native decoder unavailable")
        from ultragrid_tpu_torch.ops.h264_8x8 import LAST8_INC, SIG8_INC
        from ultragrid_tpu_torch.ops.h264_cabac_tables import (
            CONTEXT_INIT, RANGE_TAB_LPS, TRANS_IDX_LPS)

        blob = _vlc_blob()
        ctx = np.ascontiguousarray(np.asarray(CONTEXT_INIT, np.int8))
        rtab = np.ascontiguousarray(np.asarray(RANGE_TAB_LPS, np.int32))
        tlps = np.ascontiguousarray(np.asarray(TRANS_IDX_LPS, np.int32))
        sig8 = np.ascontiguousarray(np.asarray(SIG8_INC, np.int32))
        last8 = np.ascontiguousarray(np.asarray(LAST8_INC, np.int32))
        assert ctx.shape == (4, 1024, 2) and rtab.shape == (64, 4)
        assert sig8.shape == (63,) and last8.shape == (63,)
        self._h = self._lib.h264fast_create(
            blob, len(blob), ctx.ctypes.data, rtab.ctypes.data,
            tlps.ctypes.data, sig8.ctypes.data, last8.ctypes.data)
        if not self._h:
            raise UnsupportedStream("native decoder init failed")

    def decode_au(self, bs: bytes):
        """Decode one AU.  Returns the next DISPLAY-order frame, or None
        while a B stream's reorder queue is priming (rc == 1)."""
        data = np.frombuffer(bytes(bs), np.uint8)
        rc = self._lib.h264fast_decode_au(
            self._h, data.ctypes.data, data.size)
        if rc < 0:
            err = self._lib.h264fast_error(self._h)
            raise UnsupportedStream(
                (err or b"native decode failed").decode(errors="replace"))
        if rc == 1:
            return None
        return self._read_planes()

    def _read_planes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        w = ctypes.c_int()
        h = ctypes.c_int()
        if self._lib.h264fast_dims(self._h, ctypes.byref(w), ctypes.byref(h)):
            raise UnsupportedStream("no picture decoded")
        w, h = w.value, h.value
        cw, ch = (w + 1) // 2, (h + 1) // 2
        y = np.empty((h, w), np.uint8)
        cb = np.empty((ch, cw), np.uint8)
        cr = np.empty((ch, cw), np.uint8)
        self._lib.h264fast_get_planes(
            self._h, y.ctypes.data, cb.ctypes.data, cr.ctypes.data)
        return y, cb, cr

    def flush(self):
        """Drain remaining display frames from the reorder queue."""
        out = []
        while True:
            rc = self._lib.h264fast_flush_frame(self._h)
            if rc <= 0:
                break
            out.append(self._read_planes())
        return out

    def decode_stream(self, bs: bytes):
        """Split a whole elementary stream on first_mb_in_slice == 0
        boundaries (same walk as StreamDecoder.decode_stream)."""
        from ultragrid_tpu_torch.ops.h264_dec import BitReader, split_nals

        frames = []
        au: list = []

        def flush():
            if any(t in (1, 5) for t, _, _ in au):
                data = b"".join(raw for _, _, raw in au)
                got = self.decode_au(data)
                if got is not None:
                    frames.append(got)
                au.clear()

        # split_nals drops the start codes; keep raw NAL byte ranges so
        # the C side re-splits identically
        i = 0
        n = len(bs)
        starts = []
        while i < n - 3:
            if bs[i] == 0 and bs[i + 1] == 0 and (
                    bs[i + 2] == 1 or (bs[i + 2] == 0 and i + 3 < n
                                       and bs[i + 3] == 1)):
                skip = 3 if bs[i + 2] == 1 else 4
                starts.append((i, i + skip))
                i += skip
            else:
                i += 1
        for k, (raw_s, s) in enumerate(starts):
            e = starts[k + 1][0] if k + 1 < len(starts) else n
            nal_type = bs[s] & 0x1F
            raw = bs[raw_s:e]
            if nal_type in (1, 5):
                first_mb = BitReader(bytes(bs[s + 1:min(s + 9, e)])).ue()
                if first_mb == 0 and any(t in (1, 5) for t, _, _ in au):
                    flush()
            au.append((nal_type, None, raw))
        flush()
        frames.extend(self.flush())
        return frames

    def __del__(self):  # best effort
        try:
            if getattr(self, "_h", None):
                self._lib.h264fast_destroy(self._h)
                self._h = None
        except Exception:  # noqa: BLE001
            pass
