"""RFC 2435 JPEG/RTP payload (PT 26): packetizer + depacketizer.

The port's copy of ``ultragrid_tpu/net/rtpdec_jpeg.py``, over the port's own
Annex K tables, ``ZIGZAG`` and header parser (``ops/jpeg.py``).  Host code:
the JPEG file it cuts up comes from K1 on the card, and the file it rebuilds
is decoded on the card by ``JpegDecompress``.

Parity with the reference's receive-only rtpdec_jpeg (ref:
src/rtp/rtpdec_jpeg.c — main/restart/quantization header parsing, Q<128
table synthesis via the RFC Appendix A formula, JPEG header regeneration);
this implementation adds the send direction as well, so the encoder's
output can interoperate with standard RTP/JPEG receivers (ffmpeg, GStreamer,
RTSP cameras).

Wire-format notes
-----------------
* Main header (8 bytes): type-specific, 24-bit fragment offset, type, Q,
  width/8, height/8 (RFC 2435 section 3.1).
* type 0 = 4:2:2, 1 = 4:2:0; bit 0x40 = Restart Marker header present
  (dri u16, f=1 l=1 count=0x3FFF — we always send complete segments).
* Q >= 128: first fragment carries a quantization table header; the table
  bytes are copied verbatim into the JPEG DQT segments (the de-facto
  convention shared by the RFC Appendix, ffmpeg and the reference, which
  memcpy them without reordering).
* Q < 128: tables synthesized from Annex K bases with the RFC scaling —
  identical math to rtpdec_jpeg.c MakeTables.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.ops.jpeg import (
    AC_CHROMA_BITS,
    AC_CHROMA_VALS,
    AC_LUMA_BITS,
    AC_LUMA_VALS,
    DC_CHROMA_BITS,
    DC_CHROMA_VALS,
    DC_LUMA_BITS,
    DC_LUMA_VALS,
    QUANT_CHROMA,
    QUANT_LUMA,
    ZIGZAG,
    _parse_headers,
)
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("rtp.jpeg")

PT_JPEG = 26  # RFC 3551 static assignment
RTP_TYPE_RST_BIT = 0x40


def make_tables(q: int) -> Tuple[bytes, bytes]:
    """RFC 2435 Appendix A MakeTables: Q factor -> (luma, chroma) 64-byte
    tables (natural order, copied verbatim into DQT by convention)."""
    factor = min(99, max(1, q))
    scale = 5000 // factor if factor < 50 else 200 - factor * 2
    lq = np.clip((QUANT_LUMA.reshape(-1) * scale + 50) // 100, 1, 255)
    cq = np.clip((QUANT_CHROMA.reshape(-1) * scale + 50) // 100, 1, 255)
    return bytes(lq.astype(np.uint8).tolist()), bytes(cq.astype(np.uint8).tolist())


def make_jpeg_header(
    width: int,
    height: int,
    jtype: int,
    qtab_l: bytes,
    qtab_c: bytes,
    dri: int,
) -> bytes:
    """Regenerate the JFIF headers a PT-26 stream strips (ref:
    rtpdec_jpeg.c / jpeg_writer.c roles combined)."""

    def marker(m: int, payload: bytes = b"") -> bytes:
        if payload:
            return bytes([0xFF, m]) + (len(payload) + 2).to_bytes(2, "big") + payload
        return bytes([0xFF, m])

    out = marker(0xD8)
    out += marker(0xDB, bytes([0]) + qtab_l)
    out += marker(0xDB, bytes([1]) + qtab_c)
    h_y = 2 if (jtype & 1) == 0 else 2
    v_y = 1 if (jtype & 1) == 0 else 2
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([3])
    sof += bytes([1, (h_y << 4) | v_y, 0])
    sof += bytes([2, (1 << 4) | 1, 1])
    sof += bytes([3, (1 << 4) | 1, 1])
    out += marker(0xC0, sof)
    for cls, tid, bits, vals in (
        (0, 0, DC_LUMA_BITS, DC_LUMA_VALS),
        (1, 0, AC_LUMA_BITS, AC_LUMA_VALS),
        (0, 1, DC_CHROMA_BITS, DC_CHROMA_VALS),
        (1, 1, AC_CHROMA_BITS, AC_CHROMA_VALS),
    ):
        out += marker(0xC4, bytes([(cls << 4) | tid]) + bytes(bits) + bytes(vals))
    if dri:
        out += marker(0xDD, dri.to_bytes(2, "big"))
    out += marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out


# ---------------------------------------------------------------------------
# Packetizer (send side — beyond reference parity)
# ---------------------------------------------------------------------------


def packetize(jpeg: bytes, mtu_payload: int = 1400) -> List[bytes]:
    """Split a baseline JPEG into RFC 2435 payloads (marker = last one).

    The JPEG's own quantization tables ride in a quantization table header
    on the first fragment (Q=255, dynamic), so any quality is representable.
    """
    hdr = _parse_headers(jpeg)
    w, h = hdr["w"], hdr["h"]
    if w > 2040 or h > 2040:
        raise ValueError("RFC 2435 caps dimensions at 2040x2040")
    scan = jpeg[hdr["scan_start"] :]
    if scan.endswith(b"\xff\xd9"):
        scan = scan[:-2]
    sampling = (hdr["scan"][0]["h"], hdr["scan"][0]["v"])
    jtype = 0 if sampling == (2, 1) else 1
    dri = hdr["ri"]
    if dri:
        jtype |= RTP_TYPE_RST_BIT
    # DQT payloads are zigzag-ordered on the wire; _parse_headers returns
    # natural order, so re-apply the zigzag permutation for transmission
    qt_l = bytes(np.asarray(hdr["qtabs"][0])[ZIGZAG].astype(np.uint8).tolist())
    qt_c_nat = hdr["qtabs"].get(1)
    qt_c = (
        bytes(np.asarray(qt_c_nat)[ZIGZAG].astype(np.uint8).tolist())
        if qt_c_nat is not None
        else qt_l
    )

    payloads = []
    off = 0
    first = True
    while off < len(scan) or first:
        main = struct.pack("!BBHBBBB", 0, (off >> 16) & 0xFF, off & 0xFFFF,
                           jtype, 255, w // 8, h // 8)
        extra = b""
        if dri:
            extra += struct.pack("!HH", dri, 0xFFFF)  # f=1, l=1, count=0x3FFF
        if first:
            qdata = qt_l + qt_c
            extra += struct.pack("!BBH", 0, 0, len(qdata)) + qdata
            first = False
        room = mtu_payload - len(main) - len(extra)
        chunk = scan[off : off + room]
        payloads.append(main + extra + chunk)
        off += len(chunk)
    return payloads


# ---------------------------------------------------------------------------
# Depacketizer (ref: rtpdec_jpeg.c decode_frame_jpeg)
# ---------------------------------------------------------------------------


class JpegDepacketizer:
    """Reassemble PT-26 fragments into complete JPEG files.

    Feed payloads in any order; a frame completes when the marker-bit
    fragment has arrived and the byte range is gapless.
    """

    def __init__(self) -> None:
        self._frags: Dict[int, bytes] = {}
        self._end: Optional[int] = None
        self._hdr: Optional[tuple] = None
        self._qtabs: Optional[Tuple[bytes, bytes]] = None

    def reset(self) -> None:
        self._frags.clear()
        self._end = None
        self._hdr = None
        self._qtabs = None

    def feed(self, payload: bytes, marker: bool) -> Optional[bytes]:
        if len(payload) < 8:
            return None
        _ts, off_hi, off_lo, jtype, q, w8, h8 = struct.unpack("!BBHBBBB", payload[:8])
        off = (off_hi << 16) | off_lo
        pos = 8
        dri = 0
        if jtype & RTP_TYPE_RST_BIT:
            dri, _fl = struct.unpack("!HH", payload[pos : pos + 4])
            pos += 4
        if (jtype & ~(RTP_TYPE_RST_BIT | 1)) != 0:
            log.warning(f"unsupported RFC 2435 type {jtype}")
            return None
        if q >= 128 and off == 0:
            _mbz, prec, qlen = struct.unpack("!BBH", payload[pos : pos + 4])
            pos += 4
            qdata = payload[pos : pos + qlen]
            pos += qlen
            if qlen >= 128:
                self._qtabs = (qdata[:64], qdata[64:128])
            elif qlen == 64:
                self._qtabs = (qdata[:64], qdata[:64])
        if off == 0:
            if self._qtabs is None or q < 128:
                self._qtabs = make_tables(q)
            self._hdr = (w8 * 8, h8 * 8, jtype & ~RTP_TYPE_RST_BIT, dri)
        self._frags[off] = payload[pos:]
        if marker:
            self._end = off + len(payload) - pos
        if self._end is None or self._hdr is None:
            return None
        # gapless?
        want = 0
        for o in sorted(self._frags):
            if o > want:
                return None
            want = max(want, o + len(self._frags[o]))
        if want < self._end:
            return None
        scan = bytearray()
        for o in sorted(self._frags):
            frag = self._frags[o]
            scan[o : o + len(frag)] = frag
        w, h, jtype_base, dri = self._hdr
        qt_l, qt_c = self._qtabs
        jpeg = make_jpeg_header(w, h, jtype_base, qt_l, qt_c, dri) + bytes(scan)
        if not jpeg.endswith(b"\xff\xd9"):
            jpeg += b"\xff\xd9"
        self.reset()
        return jpeg
