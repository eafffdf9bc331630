"""Minimal RTSP/1.0 client (receive side) + SDP media parsing.

Counterpart of the reference's RTSP *capture* module (ref:
src/video_capture/rtsp.c — curl-based RTSP client that SETUPs and PLAYs a
remote session, then depacketizes RTP into frames).  This client speaks the
same subset: OPTIONS, DESCRIBE (SDP), SETUP (UDP unicast), PLAY, TEARDOWN,
plus periodic keepalive.  It is tested against our own RtspServer
(net/rtsp.py) — the same localhost loop the reference uses for its
standards-mode interop tests.

The port's copy of ``ultragrid_tpu/net/rtsp_client.py``; host code.  The
port's ``audio/aes67.py`` takes ``parse_sdp`` from here.
"""

from __future__ import annotations

import re
import socket
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional
from urllib.parse import urlparse

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("rtsp.client")


@dataclass
class SdpMedia:
    kind: str  # "video" | "audio"
    port: int
    payload_type: int
    encoding: str = ""
    clock: int = 90000
    channels: int = 0
    control: str = ""
    fmtp: Dict[str, str] = field(default_factory=dict)


def parse_sdp(text: str) -> List[SdpMedia]:
    """Parse the m=/a=rtpmap/a=fmtp/a=control lines we need."""
    medias: List[SdpMedia] = []
    cur: Optional[SdpMedia] = None
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("m="):
            parts = line[2:].split()
            if len(parts) >= 4:
                cur = SdpMedia(kind=parts[0], port=int(parts[1]), payload_type=int(parts[3]))
                medias.append(cur)
        elif cur is not None and line.startswith("a=rtpmap:"):
            m = re.match(r"a=rtpmap:(\d+)\s+([^/]+)/(\d+)(?:/(\d+))?", line)
            if m and int(m.group(1)) == cur.payload_type:
                cur.encoding = m.group(2).upper()
                cur.clock = int(m.group(3))
                cur.channels = int(m.group(4) or 0)
        elif cur is not None and line.startswith("a=control:"):
            cur.control = line[len("a=control:"):]
        elif cur is not None and line.startswith("a=fmtp:"):
            m = re.match(r"a=fmtp:(\d+)\s+(.*)", line)
            if m and int(m.group(1)) == cur.payload_type:
                for kv in m.group(2).split(";"):
                    k, _, v = kv.strip().partition("=")
                    if k:
                        cur.fmtp[k] = v
    # static payload types without rtpmap (RFC 3551)
    for med in medias:
        if not med.encoding:
            med.encoding = {0: "PCMU", 8: "PCMA", 26: "JPEG"}.get(med.payload_type, "")
            if med.payload_type in (0, 8):
                med.clock = 8000
    return medias


class RtspClient:
    """One RTSP session against a server; drives DESCRIBE/SETUP/PLAY."""

    def __init__(self, url: str, timeout: float = 5.0):
        self.url = url
        u = urlparse(url)
        if u.scheme != "rtsp":
            raise ValueError(f"not an rtsp:// URL: {url}")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 554
        self._sock = socket.create_connection((self.host, self.port), timeout=timeout)
        self._f = self._sock.makefile("rwb")
        self._cseq = 0
        self.session_id: Optional[str] = None
        self.medias: List[SdpMedia] = []
        self._lock = threading.Lock()
        self._keepalive: Optional[threading.Timer] = None
        self._closed = False

    def _request(self, method: str, url: Optional[str] = None, headers: Optional[dict] = None):
        with self._lock:
            self._cseq += 1
            lines = [f"{method} {url or self.url} RTSP/1.0", f"CSeq: {self._cseq}"]
            if self.session_id and method != "DESCRIBE":
                lines.append(f"Session: {self.session_id}")
            for k, v in (headers or {}).items():
                lines.append(f"{k}: {v}")
            self._f.write(("\r\n".join(lines) + "\r\n\r\n").encode())
            self._f.flush()
            status = self._f.readline().decode(errors="replace")
            resp_headers: Dict[str, str] = {}
            while True:
                h = self._f.readline()
                if not h or h in (b"\r\n", b"\n"):
                    break
                k, _, v = h.decode(errors="replace").partition(":")
                resp_headers[k.strip().lower()] = v.strip()
            body = self._f.read(int(resp_headers.get("content-length", 0) or 0))
            parts = status.split()
            code = int(parts[1]) if len(parts) >= 2 else 0
            return code, resp_headers, body

    def describe(self) -> List[SdpMedia]:
        code, _, body = self._request("DESCRIBE", headers={"Accept": "application/sdp"})
        if code != 200:
            raise ConnectionError(f"DESCRIBE failed: {code}")
        self.medias = parse_sdp(body.decode(errors="replace"))
        return self.medias

    def setup(self, media: SdpMedia, rtp_port: int) -> None:
        track = media.control or f"trackID={self.medias.index(media)}"
        url = track if track.startswith("rtsp://") else f"{self.url.rstrip('/')}/{track}"
        code, headers, _ = self._request(
            "SETUP",
            url=url,
            headers={"Transport": f"RTP/AVP;unicast;client_port={rtp_port}-{rtp_port + 1}"},
        )
        if code != 200:
            raise ConnectionError(f"SETUP failed: {code}")
        sid = headers.get("session", "")
        self.session_id = sid.split(";")[0].strip() or self.session_id

    def play(self, keepalive_interval: float = 30.0) -> None:
        code, _, _ = self._request("PLAY", headers={"Range": "npt=0-"})
        if code != 200:
            raise ConnectionError(f"PLAY failed: {code}")
        if keepalive_interval > 0:
            self._schedule_keepalive(keepalive_interval)

    def _schedule_keepalive(self, interval: float) -> None:
        if self._closed:
            return

        def tick():
            try:
                self._request("OPTIONS")
            except Exception:
                return
            self._schedule_keepalive(interval)

        self._keepalive = threading.Timer(interval, tick)
        self._keepalive.daemon = True
        self._keepalive.start()

    def teardown(self) -> None:
        self._closed = True
        if self._keepalive is not None:
            self._keepalive.cancel()
        try:
            self._request("TEARDOWN")
        except Exception:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
