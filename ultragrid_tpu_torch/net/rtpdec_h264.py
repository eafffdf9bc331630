"""RFC 6184 H.264 RTP depacketizer (PT 96 dynamic).

Parity with the reference's receive path (ref: src/rtp/rtpdec_h264.c —
single-NAL, STAP-A and FU-A handling, Annex-B start codes, frame-type
classification from NAL type).  Output is an Annex-B byte stream per access
unit, suitable for recording (RTSP camera capture) or feeding an external
decoder; HEVC (RFC 7798) uses the same shapes with a 2-byte NAL header.

The port's copy of ``ultragrid_tpu/net/rtpdec_h264.py``; host code.  As in
the reference, the sender's ``Tx`` never sends RFC 6184 (``-c h264
--rtp-standard`` still sends the UltraGrid payload); ``packetize`` is what
an RTSP camera's stream is made of, for the RTSP capture and its tests.
"""

from __future__ import annotations

from typing import List, Optional

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("rtp.h264")

START_SEQUENCE = b"\x00\x00\x00\x01"  # ref: rtpdec_h264.c:68

# H.264 NAL types (RFC 6184 section 5.2 / H.264 table 7-1)
NAL_SPS = 7
NAL_PPS = 8
NAL_IDR = 5
NAL_SEI = 6
NAL_STAP_A = 24
NAL_FU_A = 28

FRAME_INTRA = "intra"
FRAME_BFRAME = "bframe"
FRAME_OTHER = "other"


def nal_type(hdr: int) -> int:
    return hdr & 0x1F


def nal_nri(hdr: int) -> int:
    return (hdr >> 5) & 0x3


class H264Depacketizer:
    """Reassemble RFC 6184 payloads into Annex-B access units.

    Feed payloads in seq order (the pbuf already orders them); a frame
    completes on the marker bit.  SPS/PPS are remembered and re-prepended to
    IDR frames so recorded streams are self-contained, mirroring the
    reference's sprop handling.
    """

    def __init__(self) -> None:
        self._nals: List[bytes] = []
        self._fu_buf: Optional[bytearray] = None
        self.frame_type = FRAME_BFRAME
        self.sps: Optional[bytes] = None
        self.pps: Optional[bytes] = None
        self.width = 0
        self.height = 0

    def _classify(self, hdr: int, nal: bytes) -> None:
        t = nal_type(hdr)
        if t == NAL_SPS:
            self.sps = nal
        elif t == NAL_PPS:
            self.pps = nal
        if t in (NAL_IDR, NAL_SEI):
            self.frame_type = FRAME_INTRA
        elif self.frame_type == FRAME_BFRAME and nal_nri(hdr) != 0:
            self.frame_type = FRAME_OTHER


    def _push(self, nal: bytes) -> None:
        if nal:
            self._classify(nal[0], nal)
            self._nals.append(nal)

    def feed(self, payload: bytes, marker: bool) -> Optional[bytes]:
        """Process one RTP payload; returns an Annex-B access unit when the
        marker-bit packet arrives, else None."""
        if not payload:
            return None
        hdr = payload[0]
        t = nal_type(hdr)
        if 1 <= t <= 23:  # single NAL unit packet
            self._push(payload)
        elif t == NAL_STAP_A:  # aggregation: [hdr][len u16][NAL]...
            pos = 1
            while pos + 2 <= len(payload):
                ln = int.from_bytes(payload[pos : pos + 2], "big")
                pos += 2
                self._push(payload[pos : pos + ln])
                pos += ln
        elif t == NAL_FU_A:  # fragmentation unit
            if len(payload) < 2:
                return None
            fu = payload[1]
            start, end = fu & 0x80, fu & 0x40
            orig_hdr = (hdr & 0xE0) | (fu & 0x1F)
            if start:
                self._fu_buf = bytearray([orig_hdr])
            if self._fu_buf is not None:
                self._fu_buf.extend(payload[2:])
                if end:
                    self._push(bytes(self._fu_buf))
                    self._fu_buf = None
        else:
            log.warning(f"unsupported RFC 6184 NAL type {t}")
        if not marker:
            return None
        out = bytearray()
        # self-contained IDR frames: prepend parameter sets if absent
        have_ps = any(nal_type(n[0]) in (NAL_SPS, NAL_PPS) for n in self._nals)
        is_idr = any(nal_type(n[0]) == NAL_IDR for n in self._nals)
        if is_idr and not have_ps:
            for ps in (self.sps, self.pps):
                if ps:
                    out += START_SEQUENCE + ps
        for nal in self._nals:
            out += START_SEQUENCE + nal
        self._nals = []
        ft, self.frame_type = self.frame_type, FRAME_BFRAME
        if not out:
            return None
        return bytes(out)


def packetize(annexb: bytes, mtu_payload: int = 1400) -> List[bytes]:
    """RFC 6184 packetizer (ref: rtpenc_h264.c role): split an Annex-B access
    unit into single-NAL / FU-A payloads."""
    nals: List[bytes] = []
    data = annexb
    # split on 3- or 4-byte start codes
    i = 0
    starts = []
    while i < len(data) - 2:
        if data[i] == 0 and data[i + 1] == 0:
            if data[i + 2] == 1:
                starts.append((i, i + 3))
                i += 3
                continue
            if i < len(data) - 3 and data[i + 2] == 0 and data[i + 3] == 1:
                starts.append((i, i + 4))
                i += 4
                continue
        i += 1
    for n, (s, b) in enumerate(starts):
        end = starts[n + 1][0] if n + 1 < len(starts) else len(data)
        nals.append(data[b:end])
    out: List[bytes] = []
    for nal in nals:
        if not nal:
            continue
        if len(nal) <= mtu_payload:
            out.append(nal)
            continue
        hdr = nal[0]
        fu_ind = (hdr & 0xE0) | NAL_FU_A
        t = hdr & 0x1F
        body = nal[1:]
        pos = 0
        first = True
        while pos < len(body):
            chunk = body[pos : pos + mtu_payload - 2]
            pos += len(chunk)
            fu = t | (0x80 if first else 0) | (0x40 if pos >= len(body) else 0)
            out.append(bytes([fu_ind, fu]) + chunk)
            first = False
    return out
