"""AES67 audio capture: RTP L16/L24 receive + SAP/SDP announcement listener.

Parity with the reference's aes67 module (ref: src/audio/capture/aes67.cpp):
streams are discovered from SAP announcements (RFC 2974 header + SDP
payload, multicast 239.255.255.255:9875) or given directly; the RTP payload
is raw big-endian interleaved PCM (L16/L24 per RFC 3551/3190), deinterleaved
into the per-channel audio_frame2 layout.

Config: ``-s aes67:addr=<ip>:port=<p>[:codec=L24|L16][:rate=<hz>][:ch=<n>]``
or ``-s aes67:sap[:sap_ip=<ip>][:sap_port=<port>][:stream=<index>]``.

The port's copy of ``ultragrid_tpu/audio/aes67.py``.
"""

from __future__ import annotations

import queue
import socket
import struct
import threading
from typing import List, Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.audio.capture import AudioCapture
from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.net.rtsp_client import parse_sdp
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("aes67")

SAP_ADDR = ("239.255.255.255", 9875)


def parse_sap(pkt: bytes) -> Optional[str]:
    """RFC 2974: returns the SDP payload of an uncompressed v1 announcement."""
    if len(pkt) < 8:
        return None
    flags = pkt[0]
    if (flags >> 5) != 1:  # version
        return None
    if flags & 0x02 or flags & 0x01:  # compressed / encrypted unsupported
        log.warning("compressed/encrypted SAP packets are not supported")
        return None
    addr_len = 16 if flags & 0x10 else 4
    off = 4 + addr_len + (pkt[1] * 4)  # header + origin + auth data
    rest = pkt[off:]
    if rest.startswith(b"v=0"):
        return rest.decode(errors="replace")
    # optional payload-type string "application/sdp\0"
    nul = rest.find(b"\0")
    if nul >= 0 and rest[:nul] in (b"application/sdp", b""):
        return rest[nul + 1 :].decode(errors="replace")
    return None


def sap_discover(timeout: float = 3.0, sap_addr=SAP_ADDR) -> List[Tuple[str, int, str, int, int]]:
    """Listen for SAP announcements; returns (addr, port, codec, rate, ch)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("", sap_addr[1]))
    try:
        mreq = struct.pack("4sl", socket.inet_aton(sap_addr[0]), socket.INADDR_ANY)
        sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
    except OSError:
        pass
    sock.settimeout(timeout)
    found = []
    try:
        while True:
            try:
                pkt, _ = sock.recvfrom(65536)
            except socket.timeout:
                break
            sdp = parse_sap(pkt)
            if not sdp:
                continue
            # connection address from c= line
            caddr = ""
            for line in sdp.splitlines():
                if line.startswith("c=IN IP4 "):
                    caddr = line[len("c=IN IP4 "):].split("/")[0].strip()
            for m in parse_sdp(sdp):
                if m.kind == "audio" and m.encoding in ("L16", "L24"):
                    found.append((caddr, m.port, m.encoding, m.clock, m.channels or 2))
    finally:
        sock.close()
    return found


class Aes67Capture(AudioCapture):
    def __init__(self, cfg: str = ""):
        super().__init__(cfg)
        addr, port, codec, rate, ch = None, 5004, "L24", 48000, 2
        sap = False
        sap_addr = SAP_ADDR
        stream_idx = 0
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "addr":
                addr = val
            elif key == "port":
                port = int(val)
            elif key == "codec":
                codec = val.upper()
            elif key == "rate":
                rate = int(val)
            elif key == "ch":
                ch = int(val)
            elif key == "sap":
                sap = True
            elif key == "sap_ip":
                sap_addr = (val, sap_addr[1])
            elif key == "sap_port":
                sap_addr = (sap_addr[0], int(val))
            elif key == "stream":
                stream_idx = int(val)
        if sap:
            streams = sap_discover(sap_addr=sap_addr)
            if not streams:
                raise RuntimeError("aes67: no SAP announcements received")
            addr, port, codec, rate, ch = streams[stream_idx]
            log.notice(f"SAP stream {stream_idx}: {addr}:{port} {codec}/{rate}/{ch}")
        if codec not in ("L16", "L24"):
            raise ValueError(f"aes67: unsupported codec {codec}")
        self.bps = 2 if codec == "L16" else 3
        self.desc = AudioDesc(bps=self.bps, sample_rate=rate, ch_count=ch, codec="PCM")
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("", port))
        if addr and addr.split(".")[0].isdigit() and 224 <= int(addr.split(".")[0]) <= 239:
            try:
                mreq = struct.pack("4sl", socket.inet_aton(addr), socket.INADDR_ANY)
                self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
            except OSError:
                pass
        self.sock.settimeout(0.25)
        self._buf: "queue.Queue[bytes]" = queue.Queue(maxsize=512)
        self._pending = b""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._rx, name="aes67-rx", daemon=True)
        self._thread.start()

    def _rx(self) -> None:
        while not self._stop.is_set():
            try:
                pkt, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if len(pkt) < 12 or (pkt[0] >> 6) != 2:
                continue
            cc = pkt[0] & 0xF
            off = 12 + 4 * cc
            try:
                self._buf.put_nowait(pkt[off:])
            except queue.Full:
                pass

    def read(self, nsamples: int) -> Optional[AudioFrame]:
        need = nsamples * self.bps * self.desc.ch_count
        data = self._pending
        while len(data) < need:
            try:
                data += self._buf.get(timeout=1.0)
            except queue.Empty:
                if not data:
                    return None
                break
        take = (len(data) // (self.bps * self.desc.ch_count)) * self.bps * self.desc.ch_count
        take = min(take, need)
        chunk, self._pending = data[:take], data[take:]
        # big-endian network PCM -> per-channel little-endian (audio_frame2)
        raw = np.frombuffer(chunk, np.uint8).reshape(-1, self.desc.ch_count, self.bps)
        le = raw[:, :, ::-1]  # byte-swap BE -> LE
        channels = [np.ascontiguousarray(le[:, c]).reshape(-1) for c in range(self.desc.ch_count)]
        frame = AudioFrame(self.desc, channels)
        return frame

    def done(self) -> None:
        self._stop.set()
        try:
            self.sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)


register_module("aes67", LibraryClass.AUDIO_CAPTURE, Aes67Capture)
