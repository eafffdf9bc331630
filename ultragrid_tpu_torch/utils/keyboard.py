"""Interactive keyboard control (ref: src/keyboard_control.cpp); the port's
copy of ``ultragrid_tpu/utils/keyboard.py``.

Default keys mirror the reference: 'm' mute audio, '+'/'-' volume,
'p' pause, space resume, 'v'/'V' verbosity, 'q' quit, 'h' help.  A user
keymap file (``ug-key-map.txt``, lines of ``key:command``) can remap keys to
control-socket commands (ref: keyboard_control.cpp:101).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Callable, Dict, Optional

from ultragrid_tpu_torch.modules.messaging import Module, MsgSender, send_message
from ultragrid_tpu_torch.utils import log as _log
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("keyboard")

DEFAULT_KEYMAP_FILE = "ug-key-map.txt"


class KeyboardControl:
    def __init__(self, root: Module, keymap_path: Optional[str] = None,
                 on_exit: Optional[Callable[[], None]] = None):
        self.root = root
        self.keymap: Dict[str, str] = {}
        self.should_exit = threading.Event()
        self.on_exit = on_exit  # 'q' propagates to the owning pipeline
        path = keymap_path or DEFAULT_KEYMAP_FILE
        if os.path.exists(path):
            self._load_keymap(path)
        self._thread: Optional[threading.Thread] = None

    def _load_keymap(self, path: str) -> None:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or ":" not in line:
                    continue
                key, _, cmd = line.partition(":")
                self.keymap[key.strip()] = cmd.strip()
        log.info(f"loaded {len(self.keymap)} key mappings from {path}")

    def handle_key(self, key: str) -> bool:
        """Process one key; returns False to request exit."""
        if key in self.keymap:
            # mapped keys dispatch control-socket commands (same router as
            # the TCP server; ref: keyboard_control.cpp keymap execution)
            from ultragrid_tpu_torch.utils.control_socket import dispatch_command

            resp = dispatch_command(self.root, self.keymap[key])
            if resp.code != 200:
                log.warning(f"key {key!r} -> {self.keymap[key]!r}: "
                            f"{resp.code} {resp.text or ''}")
            return True
        if key == "q":
            self.should_exit.set()
            if self.on_exit is not None:
                self.on_exit()
            return False
        if key == "m":
            # toggle handled receiver-side (ref: keyboard_control.cpp 'm')
            from ultragrid_tpu_torch.modules.messaging import MsgReceiver

            send_message(self.root, "receiver", MsgReceiver(volume="toggle-mute"))
        elif key == "+":
            from ultragrid_tpu_torch.modules.messaging import MsgReceiver

            send_message(self.root, "receiver", MsgReceiver(volume="up"))
        elif key == "-":
            from ultragrid_tpu_torch.modules.messaging import MsgReceiver

            send_message(self.root, "receiver", MsgReceiver(volume="down"))
        elif key == "p":
            send_message(self.root, "sender", MsgSender(paused=True))
        elif key == " ":
            send_message(self.root, "sender", MsgSender(paused=False))
        elif key == "v":
            _log.set_log_level(min(_log.log_level + 1, 8))
            log.notice(f"log level {_log.log_level}")
        elif key == "V":
            _log.set_log_level(max(_log.log_level - 1, 0))
            log.notice(f"log level {_log.log_level}")
        elif key == "h":
            print(self.usage())
        return True

    @staticmethod
    def usage() -> str:
        return (
            "keys: m mute | +/- volume | p pause | space play | "
            "v/V verbosity | q quit | h help"
        )

    def start(self) -> None:
        """Start the stdin reader (raw mode if a TTY)."""
        if not sys.stdin.isatty():
            return

        def reader():
            import termios
            import tty

            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            try:
                tty.setcbreak(fd)
                while not self.should_exit.is_set():
                    ch = sys.stdin.read(1)
                    if not self.handle_key(ch):
                        break
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)

        self._thread = threading.Thread(target=reader, name="keyboard", daemon=True)
        self._thread.start()
