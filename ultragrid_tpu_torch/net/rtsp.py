"""Minimal RTSP/1.0 server for standards-mode streams.

Parity with the reference's RTSP support (ref: src/rtsp/BasicRTSPOnlyServer.cpp
+ src/rxtx rtsp mode — live555-based server announcing the UltraGrid session
so standard clients can SETUP/PLAY it).  This implementation speaks the RTSP
subset those clients use — OPTIONS, DESCRIBE (SDP), SETUP (UDP unicast),
PLAY, PAUSE, TEARDOWN — and hands each playing client's (address, rtp_port)
to a callback so the sender can add it as an RTP destination (RFC 2435 JPEG
payloads pair with this; see net/rtpdec_jpeg.py).

The port's copy of ``ultragrid_tpu/net/rtsp.py``; host code.  It binds the
same default port (8554) as ``utils/sdp.py``'s HTTP server, so under
``--rtsp`` the SDP server cannot start (ROADMAP F10, as in the reference).
"""

from __future__ import annotations

import random
import socketserver
import threading
from typing import Callable, Dict, List, Optional, Tuple

from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.sdp import make_sdp

log = Logger("rtsp")

DEFAULT_RTSP_PORT = 8554


class RtspServer:
    """RTSP endpoint announcing one video (and optionally audio) stream.

    on_play(addr, rtp_port) / on_teardown(addr, rtp_port) notify the sender
    which destinations are active.
    """

    def __init__(
        self,
        streams: List[Tuple[str, int, int, str, int]],
        port: int = DEFAULT_RTSP_PORT,
        on_play: Optional[Callable[[str, int], None]] = None,
        on_teardown: Optional[Callable[[str, int], None]] = None,
        session_name: str = "UltraGrid-TPU session",
    ):
        self.streams = streams
        self.on_play = on_play
        self.on_teardown = on_teardown
        self.session_name = session_name
        self.sessions: Dict[str, dict] = {}
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):  # one connection may carry many requests
                while True:
                    try:
                        req = self._read_request()
                    except (ConnectionError, OSError):
                        return
                    if req is None:
                        return
                    method, url, headers = req
                    cseq = headers.get("cseq", "0")
                    if method == "OPTIONS":
                        self._reply(cseq, extra={
                            "Public": "OPTIONS, DESCRIBE, SETUP, PLAY, PAUSE, TEARDOWN"
                        })
                    elif method == "DESCRIBE":
                        ip = self.connection.getsockname()[0]
                        sdp = make_sdp(ip, outer.streams, outer.session_name)
                        self._reply(cseq, body=sdp, extra={
                            "Content-Type": "application/sdp",
                            "Content-Base": url,
                        })
                    elif method == "SETUP":
                        transport = headers.get("transport", "")
                        rtp_port = 0
                        for part in transport.split(";"):
                            if part.startswith("client_port="):
                                rtp_port = int(part[12:].split("-")[0])
                        if "RTP/AVP" not in transport or rtp_port == 0:
                            self._reply(cseq, code=461, reason="Unsupported Transport")
                            continue
                        sid = f"{random.getrandbits(32):08X}"
                        addr = self.client_address[0]
                        outer.sessions[sid] = {"addr": addr, "rtp_port": rtp_port}
                        self._reply(cseq, extra={
                            "Transport": (
                                f"RTP/AVP;unicast;client_port={rtp_port}-{rtp_port + 1};"
                                f"server_port={outer.streams[0][1]}-{outer.streams[0][1] + 1}"
                            ),
                            "Session": sid,
                        })
                    elif method == "PLAY":
                        sid = headers.get("session", "")
                        sess = outer.sessions.get(sid)
                        if sess is None:
                            self._reply(cseq, code=454, reason="Session Not Found")
                            continue
                        if outer.on_play:
                            outer.on_play(sess["addr"], sess["rtp_port"])
                        self._reply(cseq, extra={"Session": sid, "Range": "npt=0-"})
                    elif method == "PAUSE":
                        sid = headers.get("session", "")
                        sess = outer.sessions.get(sid)
                        if sess and outer.on_teardown:
                            outer.on_teardown(sess["addr"], sess["rtp_port"])
                        self._reply(cseq, extra={"Session": sid})
                    elif method == "TEARDOWN":
                        sid = headers.get("session", "")
                        sess = outer.sessions.pop(sid, None)
                        if sess and outer.on_teardown:
                            outer.on_teardown(sess["addr"], sess["rtp_port"])
                        self._reply(cseq, extra={"Session": sid})
                        return
                    else:
                        self._reply(cseq, code=501, reason="Not Implemented")

            def _read_request(self):
                line = self.rfile.readline()
                if not line:
                    return None
                parts = line.decode(errors="replace").strip().split()
                if len(parts) < 3:
                    return None
                method, url = parts[0], parts[1]
                headers = {}
                while True:
                    h = self.rfile.readline()
                    if not h or h in (b"\r\n", b"\n"):
                        break
                    k, _, v = h.decode(errors="replace").partition(":")
                    headers[k.strip().lower()] = v.strip()
                n = int(headers.get("content-length", 0) or 0)
                if n:
                    self.rfile.read(n)
                return method, url, headers

            def _reply(self, cseq, code=200, reason="OK", body="", extra=None):
                out = [f"RTSP/1.0 {code} {reason}", f"CSeq: {cseq}"]
                for k, v in (extra or {}).items():
                    out.append(f"{k}: {v}")
                data = body.encode() if isinstance(body, str) else body
                if data:
                    out.append(f"Content-Length: {len(data)}")
                msg = ("\r\n".join(out) + "\r\n\r\n").encode() + data
                self.wfile.write(msg)

        class Server(socketserver.ThreadingTCPServer):
            daemon_threads = True
            allow_reuse_address = True

        self._srv = Server(("", port), Handler)
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        log.notice(f"RTSP server on rtsp://0.0.0.0:{self.port}/")

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
