"""Web GUI: browser front-end replacing the reference's Qt GUI.

The port's copy of ``ultragrid_tpu/tools/webui.py`` (jax-free; copied, not imported, so
the port never runs the JAX package's ``__init__``).

The reference GUI (ref: gui/QT/, 5.2 kLoC) spawns ``uv``, shows a live
preview received over the ipc_frame unix socket, and drives the session via
the control socket; this is the same architecture with a browser as the
widget toolkit:

  * ``GET /``            — single-page UI (preview + stats + command box)
  * ``GET /preview``     — multipart/x-mixed-replace MJPEG built from the
                           ipc_frame stream of a ``-d preview`` /
                           ``--capture-filter preview`` session
  * ``GET /stats``       — latest stats lines from the control socket
  * ``POST /control``    — forward one command line to the control socket
  * ``GET /capabilities``— the machine-readable capabilities JSON (the same
                           contract the Qt GUI consumes)

Run ``python -m ultragrid_tpu_torch.tools.webui [--port 8600]`` and point a
sender at it with ``-d preview`` (or add ``--capture-filter preview``).
"""

from __future__ import annotations

import argparse
import io
import json
import os
import socket
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

_PAGE = """<!DOCTYPE html>
<html><head><title>ultragrid_tpu</title><style>
body{font-family:sans-serif;background:#111;color:#eee;margin:2em}
img{border:1px solid #444;max-width:100%}
pre{background:#1a1a1a;padding:1em;max-height:14em;overflow:auto}
input{width:24em} button{margin-left:.5em}
</style></head><body>
<h2>ultragrid_tpu</h2>
<img src="/preview" alt="preview (start a session with -d preview)">
<h3>stats</h3><pre id="stats"></pre>
<h3>control</h3>
<input id="cmd" placeholder="e.g. compress jpeg:80  |  volume up  |  mute">
<button onclick="send()">send</button> <span id="resp"></span>
<script>
async function poll(){
  try{const r=await fetch('/stats');document.getElementById('stats').textContent=await r.text();}catch(e){}
  setTimeout(poll, 1000);
}
async function send(){
  const c=document.getElementById('cmd').value;
  const r=await fetch('/control',{method:'POST',body:c});
  document.getElementById('resp').textContent=await r.text();
}
poll();
</script></body></html>"""


class PreviewHub:
    """Accepts ONE ipc_frame producer and fans JPEG-encoded frames out to
    any number of HTTP clients."""

    def __init__(self, path: str):
        self.path = path
        self._jpeg: Optional[bytes] = None
        self._seq = 0
        self._cond = threading.Condition()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        from ultragrid_tpu_torch.modules.ipc_display import IpcFrameReader

        while True:
            reader = IpcFrameReader(self.path)
            try:
                reader.accept(timeout=86400.0)
                while True:
                    got = reader.read_frame(timeout=86400.0)
                    if got is None:
                        break
                    w, h, color, data = got
                    jpg = self._encode(w, h, data)
                    if jpg is None:
                        continue
                    with self._cond:
                        self._jpeg = jpg
                        self._seq += 1
                        self._cond.notify_all()
            except OSError:
                time.sleep(0.5)
            finally:
                reader.close()

    @staticmethod
    def _encode(w: int, h: int, rgb: bytes) -> Optional[bytes]:
        try:
            from PIL import Image

            img = Image.frombytes("RGB", (w, h), rgb)
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=80)
            return buf.getvalue()
        except Exception:
            return None

    def next_jpeg(self, last_seq: int, timeout: float = 5.0):
        with self._cond:
            self._cond.wait_for(lambda: self._seq != last_seq, timeout=timeout)
            return self._jpeg, self._seq


class ControlBridge:
    """Client of the session's control socket (port 5054 by default)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 5054):
        self.host, self.port = host, port
        self.stats: List[str] = []
        self._lock = threading.Lock()
        threading.Thread(target=self._stats_loop, daemon=True).start()

    def _stats_loop(self) -> None:
        while True:
            try:
                with socket.create_connection((self.host, self.port), timeout=5) as s:
                    s.sendall(b"stats on\r\n")
                    f = s.makefile("r")
                    for line in f:
                        with self._lock:
                            self.stats.append(line.rstrip())
                            del self.stats[:-30]
            except OSError:
                time.sleep(1.0)

    def get_stats(self) -> str:
        with self._lock:
            return "\n".join(self.stats[-20:])

    def command(self, line: str) -> str:
        try:
            with socket.create_connection((self.host, self.port), timeout=5) as s:
                s.sendall(line.strip().encode() + b"\r\n")
                s.settimeout(2.0)
                try:
                    return s.recv(4096).decode(errors="replace").strip()
                except socket.timeout:
                    return "(no response)"
        except OSError as exc:
            return f"control socket unavailable: {exc}"


def make_server(port: int, preview_path: str, control_port: int,
                host: str = "127.0.0.1", token: str = ""):
    hub = PreviewHub(preview_path)
    bridge = ControlBridge(port=control_port)
    allowed_hosts = {"localhost", "127.0.0.1", "[::1]", host}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif self.path == "/stats":
                self._send(200, "text/plain", bridge.get_stats().encode())
            elif self.path == "/capabilities":
                from ultragrid_tpu_torch.utils.capabilities import get_capabilities

                self._send(200, "application/json",
                           json.dumps(get_capabilities()).encode())
            elif self.path == "/preview":
                self.send_response(200)
                self.send_header(
                    "Content-Type", "multipart/x-mixed-replace; boundary=ugframe"
                )
                self.end_headers()
                seq = -1
                try:
                    while True:
                        jpg, seq2 = hub.next_jpeg(seq)
                        if jpg is None or seq2 == seq:
                            continue
                        seq = seq2
                        self.wfile.write(
                            b"--ugframe\r\nContent-Type: image/jpeg\r\n"
                            + f"Content-Length: {len(jpg)}\r\n\r\n".encode()
                            + jpg + b"\r\n"
                        )
                except (BrokenPipeError, ConnectionError):
                    return
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if self.path == "/control":
                # Host check blocks DNS-rebinding; token gates non-local
                # binds (control socket can reconfigure the session).
                hdr_host = (self.headers.get("Host") or "").rsplit(":", 1)[0]
                if hdr_host not in allowed_hosts:
                    self._send(403, "text/plain", b"forbidden (bad Host)")
                    return
                if token and self.headers.get("X-Auth-Token") != token:
                    self._send(403, "text/plain", b"forbidden (token)")
                    return
                n = int(self.headers.get("Content-Length", 0) or 0)
                cmd = self.rfile.read(n).decode(errors="replace")
                self._send(200, "text/plain", bridge.command(cmd).encode())
            else:
                self._send(404, "text/plain", b"not found")

    srv = ThreadingHTTPServer((host, port), Handler)
    return srv, hub, bridge


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--port", type=int, default=8600)
    p.add_argument("--preview-path", default=os.path.join(
        tempfile.gettempdir(), "ug_preview_disp_unix"))
    p.add_argument("--control-port", type=int, default=5054)
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (default loopback only; "
                        "non-local binds should set --token)")
    p.add_argument("--token", default="",
                   help="require X-Auth-Token header on /control")
    args = p.parse_args(argv)
    srv, _, _ = make_server(args.port, args.preview_path, args.control_port,
                            host=args.host, token=args.token)
    print(f"web UI on http://{args.host}:{srv.server_address[1]}/ "
          f"(preview socket {args.preview_path})", file=sys.stderr)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
