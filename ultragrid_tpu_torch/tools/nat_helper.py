"""Hole-punching coordination server (ref: nat-helper/ in the reference).

The port's copy of ``ultragrid_tpu/tools/nat_helper.py`` (jax-free; copied, not imported, so
the port never runs the JAX package's ``__init__``).

Wire protocol (ref: nat-helper/README.md, message.cpp): every message is
``<5-byte ASCII length header><body>`` (max 2048 B body).  A client sends its
name, then a room name, then its SDP description; once two clients share a
room each receives the other's name, description, and subsequently any
candidate messages, forwarded verbatim.

Run: ``python -m ultragrid_tpu_torch.tools.nat_helper [-p PORT]`` (default 12558).
"""

from __future__ import annotations

import socket
import socketserver
import sys
import threading
from typing import Dict, List, Optional

DEFAULT_PORT = 12558  # ref: nat-helper/main.cpp
MAX_BODY = 2048


def send_msg(sock: socket.socket, body: bytes) -> None:
    sock.sendall(f"{len(body):<5d}".encode()[:5] + body)


def recv_msg(sock: socket.socket) -> Optional[bytes]:
    hdr = b""
    while len(hdr) < 5:
        chunk = sock.recv(5 - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    try:
        n = int(hdr.rstrip(b"\x00 ").decode())
    except ValueError:
        return None
    if n < 0 or n > MAX_BODY:
        return None
    body = b""
    while len(body) < n:
        chunk = sock.recv(n - len(body))
        if not chunk:
            return None
        body += chunk
    return body


class _Client:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.name: Optional[bytes] = None
        self.sdp: Optional[bytes] = None
        self.peer: Optional["_Client"] = None
        self.pending: List[bytes] = []
        self.lock = threading.Lock()

    def send(self, body: bytes) -> None:
        with self.lock:
            send_msg(self.sock, body)


class NatHelperServer:
    """Room-based pairing server; two clients per room."""

    def __init__(self, port: int = DEFAULT_PORT, host: str = "0.0.0.0"):
        self.rooms: Dict[bytes, List[_Client]] = {}
        self.rooms_lock = threading.Lock()
        srv = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self) -> None:
                srv._handle(self.request)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = Server((host, port), Handler)
        self.port = self._tcp.server_address[1]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="nat-helper", daemon=True
        )

    def start(self) -> None:
        self._thread.start()

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()

    # -- connection state machine (ref: client.cpp) -----------------------

    def _handle(self, sock: socket.socket) -> None:
        client = _Client(sock)
        room_name = None
        try:
            client.name = recv_msg(sock)
            room_name = recv_msg(sock)
            client.sdp = recv_msg(sock)
            if not client.name or not room_name or client.sdp is None:
                return
            with self.rooms_lock:
                room = self.rooms.setdefault(room_name, [])
                room.append(client)
                if len(room) == 2:
                    a, b = room
                    # forward names then descriptions (README steps 4-5),
                    # THEN mark paired and flush early candidates — all under
                    # the lock so no forward can interleave with pairing
                    a.send(b.name)
                    b.send(a.name)
                    a.send(b.sdp)
                    b.send(a.sdp)
                    a.peer, b.peer = b, a
                    for m in a.pending:
                        b.send(m)
                    for m in b.pending:
                        a.send(m)
                    a.pending.clear()
                    b.pending.clear()
            # candidate forwarding loop
            while True:
                msg = recv_msg(sock)
                if msg is None:
                    return
                with self.rooms_lock:
                    peer = client.peer
                    if peer is None:
                        client.pending.append(msg)
                        continue
                peer.send(msg)
        except OSError:
            pass
        finally:
            if room_name is not None:
                with self.rooms_lock:
                    room = self.rooms.get(room_name, [])
                    if client in room:
                        room.remove(client)
                    if not room:
                        self.rooms.pop(room_name, None)


def main() -> None:
    port = DEFAULT_PORT
    args = sys.argv[1:]
    if args and args[0] in ("-p", "--port"):
        port = int(args[1])
    srv = NatHelperServer(port)
    srv.start()
    print(f"nat-helper listening on {srv.port}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.close()


if __name__ == "__main__":
    main()
