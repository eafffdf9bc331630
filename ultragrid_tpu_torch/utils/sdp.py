"""SDP generation + tiny HTTP server for standards-compliant RTP sessions.

The port's copy of ``ultragrid_tpu/utils/sdp.py`` (ref: src/utils/sdp.c —
v=0/o=/s=/c=/t= preamble, per-stream m= + a=rtpmap lines, an optional
embedded HTTP server on port 8554 so receivers can fetch the session
description; used together with the RFC-compliant payloads like RFC 2435
JPEG).  Host code, no device work.

The HTTP server binds the same port as the RTSP server
(``net/rtsp.py`` ``DEFAULT_RTSP_PORT``): under ``--rtsp`` the second bind
fails and the sender logs "SDP HTTP server unavailable", as the reference
does (ROADMAP F10).
"""

from __future__ import annotations

import http.server
import socketserver
import threading
from typing import List, Tuple

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("sdp")

DEFAULT_SDP_HTTP_PORT = 8554  # ref: sdp.c DEFAULT_SDP_HTTP_PORT


def make_sdp(
    dest_ip: str,
    streams: List[Tuple[str, int, int, str, int]],
    session_name: str = "UltraGrid-TPU session",
) -> str:
    """Build an SDP document.

    streams: list of (kind, port, pt, encoding, clock) tuples, e.g.
    ("video", 5004, 26, "JPEG", 90000) or ("audio", 5006, 0, "PCMU", 8000).
    Every stream gets an ``a=rtpmap`` line, static payload types included.
    """
    ipv = 6 if ":" in dest_ip else 4
    out = [
        "v=0",
        f"o=- 0 0 IN IP{ipv} {dest_ip}",
        f"s={session_name}",
        f"c=IN IP{ipv} {dest_ip}",
        "t=0 0",
    ]
    for kind, port, pt, encoding, clock in streams:
        out.append(f"m={kind} {port} RTP/AVP {pt}")
        out.append(f"a=rtpmap:{pt} {encoding}/{clock}")
    return "\r\n".join(out) + "\r\n"


class SdpHttpServer:
    """Serve the SDP document over HTTP (GET /ultragrid.sdp)."""

    def __init__(self, sdp_text: str, port: int = DEFAULT_SDP_HTTP_PORT):
        body = sdp_text.encode()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                self.send_response(200)
                self.send_header("Content-Type", "application/sdp")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence default stderr spam
                pass

        self._srv = socketserver.TCPServer(("", port), Handler, bind_and_activate=False)
        self._srv.allow_reuse_address = True
        try:
            self._srv.server_bind()
            self._srv.server_activate()
        except OSError:
            self._srv.server_close()
            raise
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever, daemon=True)
        self._thread.start()
        log.notice(f"SDP served at http://0.0.0.0:{self.port}/ultragrid.sdp")

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
