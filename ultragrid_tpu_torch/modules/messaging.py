"""Module tree + message bus for runtime reconfiguration.

The port's copy of ``ultragrid_tpu/modules/messaging.py`` (jax-free), the
analogue of the reference's hierarchical module tree with path
addressing and typed messages with HTTP-like responses
(ref: src/module.h:76-199, src/messaging.h:59-184).

Example: ``send_message(root, "sender.compress", MsgChangeCompress("JPEG:80"))``
reaches the compress driver, which rebuilds its device pipeline off-thread and
atomically swaps it in (same goal as src/video_compress.cpp:147-209).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Callable, Dict, List, Optional

# HTTP-like response codes (ref: messaging.h RESPONSE_*)
RESPONSE_OK = 200
RESPONSE_ACCEPTED = 202
RESPONSE_BAD_REQUEST = 400
RESPONSE_NOT_FOUND = 404
RESPONSE_REQ_TIMEOUT = 408
RESPONSE_INT_SERV_ERR = 500
RESPONSE_NOT_IMPL = 501


@dataclasses.dataclass
class Response:
    code: int
    text: str = ""

    @property
    def ok(self) -> bool:
        return self.code < 300


@dataclasses.dataclass
class Message:
    """Base message; mirror of struct message (ref: messaging.h:59)."""


@dataclasses.dataclass
class MsgUniversal(Message):
    """Generic text message (ref: msg_universal, messaging.h:166-184)."""

    text: str


@dataclasses.dataclass
class MsgChangeCompress(Message):
    """ref: msg_change_compress_data, messaging.h."""

    config: str


@dataclasses.dataclass
class MsgChangeFec(Message):
    """ref: fec change handling, rxtx/rtp_common.c:216-241."""

    fec: str


@dataclasses.dataclass
class MsgSender(Message):
    """Sender reconfig: port/receiver/pause (ref: msg_sender, messaging.h)."""

    receiver: Optional[str] = None
    port: Optional[int] = None
    paused: Optional[bool] = None


@dataclasses.dataclass
class MsgReceiver(Message):
    port: Optional[int] = None
    postprocess: Optional[str] = None
    # audio playback control (ref: control_socket.c volume/mute commands)
    volume: Optional[str] = None  # "up" | "down" | "mute" | "unmute" | float
    av_delay_ms: Optional[int] = None  # ref: av-delay command


class Module:
    """Named node in the module tree (ref: struct module, module.h:76-137)."""

    def __init__(self, name: str, parent: Optional["Module"] = None):
        self.name = name
        self.parent = parent
        self.children: Dict[str, "Module"] = {}
        self.msg_queue: "queue.Queue[Message]" = queue.Queue()
        self.msg_callback: Optional[Callable[[Message], Response]] = None
        self._lock = threading.Lock()
        if parent is not None:
            with parent._lock:
                parent.children[name] = self

    def remove(self) -> None:
        if self.parent is not None:
            with self.parent._lock:
                self.parent.children.pop(self.name, None)

    def path(self) -> str:
        parts: List[str] = []
        node: Optional[Module] = self
        while node is not None and node.parent is not None:
            parts.append(node.name)
            node = node.parent
        return ".".join(reversed(parts))

    def find(self, path: str) -> Optional["Module"]:
        node: Optional[Module] = self
        for part in path.split("."):
            if node is None or part not in node.children:
                return None
            node = node.children[part]
        return node


def send_message(root: Module, path: str, msg: Message) -> Response:
    """Deliver a message to the module at `path` (ref: messaging.h:177)."""
    target = root.find(path)
    if target is None:
        return Response(RESPONSE_NOT_FOUND, f"no module at {path}")
    if target.msg_callback is not None:
        return target.msg_callback(msg)
    target.msg_queue.put(msg)
    return Response(RESPONSE_ACCEPTED)


def check_message(module: Module) -> Optional[Message]:
    """Non-blocking poll of a module's queue (ref: check_message, module.h)."""
    try:
        return module.msg_queue.get_nowait()
    except queue.Empty:
        return None
