"""Runtime control TCP socket (ref: src/control_socket.c, default port 5054);
the port's copy of ``ultragrid_tpu/utils/control_socket.py``.

Line-based protocol: commands are dispatched onto the module message bus
(``compress JPEG:80``, ``fec ldgm:...``, ``receiver <addr>``, ``pause``,
``play``, ``stats on|off``); responses use the reference's HTTP-like codes.
Stats lines are pushed to clients that enabled them
(ref: control_report_stats, src/transmit.c:625-648).
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, List, Optional

from ultragrid_tpu_torch.modules.messaging import (
    Module,
    MsgChangeCompress,
    MsgChangeFec,
    MsgReceiver,
    MsgSender,
    RESPONSE_BAD_REQUEST,
    RESPONSE_NOT_FOUND,
    RESPONSE_OK,
    Response,
    send_message,
)
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("control")

DEFAULT_CONTROL_PORT = 5054  # ref: control_socket.c:178


def dispatch_command(root: Module, line: str) -> Response:
    """Route one control command onto the message bus (shared by the TCP
    server and keyboard keymap entries; ref: process_msg,
    control_socket.c:423-660)."""
    parts = line.strip().split(None, 1)
    if not parts:
        return Response(RESPONSE_BAD_REQUEST, "empty command")
    cmd = parts[0]
    arg = parts[1] if len(parts) > 1 else ""
    if cmd == "compress":
        return send_message(root, "sender.compress", MsgChangeCompress(arg))
    if cmd == "fec":
        return send_message(root, "sender", MsgChangeFec(arg))
    if cmd == "receiver":
        return send_message(root, "sender", MsgSender(receiver=arg))
    if cmd in ("port", "sender-port"):
        try:
            return send_message(root, "sender",
                                MsgSender(port=int(arg.split(":")[0])))
        except ValueError:
            return Response(RESPONSE_BAD_REQUEST, "bad port")
    if cmd in ("receiver-port", "reset-ssrc"):
        # removed in the reference too (control_socket.c handle_removed_feature)
        return Response(501, "feature removed")
    if cmd == "pause":
        return send_message(root, "sender", MsgSender(paused=True))
    if cmd == "play":
        return send_message(root, "sender", MsgSender(paused=False))
    if cmd == "postprocess":
        # runtime display-postprocess swap on the receiver
        # (ref: postprocess message, control_socket.c command set)
        return send_message(root, "receiver",
                            MsgReceiver(postprocess="" if arg == "none" else arg))
    if cmd in ("mute", "unmute"):
        return send_message(root, "receiver", MsgReceiver(volume=cmd))
    if cmd == "volume":
        return send_message(root, "receiver", MsgReceiver(volume=arg))
    if cmd == "av-delay":
        try:
            return send_message(root, "receiver",
                                MsgReceiver(av_delay_ms=int(arg)))
        except ValueError:
            return Response(RESPONSE_BAD_REQUEST, "bad delay")
    if cmd == "noop":
        return Response(RESPONSE_OK)
    if cmd == "help":
        return Response(RESPONSE_OK,
                        "compress fec receiver port pause play postprocess "
                        "volume mute unmute av-delay stats noop help bye quit")
    return Response(RESPONSE_NOT_FOUND, f"unknown command {cmd}")


class ControlServer:
    def __init__(self, root: Module, port: int = DEFAULT_CONTROL_PORT):
        self.root = root
        self.port = port
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", port))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self._clients: List[socket.socket] = []
        self._stats_clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop, name="control", daemon=True)
        self._thread.start()

    # -- command dispatch ----------------------------------------------

    def _dispatch(self, line: str) -> Response:
        return dispatch_command(self.root, line)

    # -- networking -----------------------------------------------------

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.25)
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._clients.append(conn)
            threading.Thread(
                target=self._client_loop, args=(conn,), daemon=True
            ).start()

    def _client_loop(self, conn: socket.socket) -> None:
        buf = b""
        try:
            while not self._stop.is_set():
                data = conn.recv(4096)
                if not data:
                    break
                buf += data
                while b"\n" in buf or b"\r" in buf:
                    line, _, buf = buf.replace(b"\r\n", b"\n").partition(b"\n")
                    text = line.decode(errors="replace").strip()
                    if not text:
                        continue
                    if text == "stats on":
                        with self._lock:
                            self._stats_clients.append(conn)
                        self._reply(conn, Response(RESPONSE_OK))
                        continue
                    if text == "stats off":
                        with self._lock:
                            if conn in self._stats_clients:
                                self._stats_clients.remove(conn)
                        self._reply(conn, Response(RESPONSE_OK))
                        continue
                    if text in ("quit", "exit", "bye"):
                        conn.close()
                        return
                    self._reply(conn, self._dispatch(text))
        except OSError:
            pass
        finally:
            with self._lock:
                if conn in self._clients:
                    self._clients.remove(conn)
                if conn in self._stats_clients:
                    self._stats_clients.remove(conn)

    @staticmethod
    def _reply(conn: socket.socket, resp: Response) -> None:
        text = {200: "OK", 202: "Accepted", 400: "Bad Request", 404: "Not Found",
                500: "Internal Server Error", 501: "Not Implemented"}.get(resp.code, "")
        msg = f"{resp.code} {text}"
        if resp.text:
            msg += f" - {resp.text}"
        try:
            conn.sendall((msg + "\r\n").encode())
        except OSError:
            pass

    def report_stats(self, line: str) -> None:
        """Push a machine-readable stats line to subscribed clients."""
        with self._lock:
            clients = list(self._stats_clients)
        for c in clients:
            try:
                c.sendall((line + "\r\n").encode())
            except OSError:
                pass

    def close(self) -> None:
        self._stop.set()
        self._sock.close()
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
