"""Leveled logging with module prefixes (ref: src/debug.h:56-110).

The port's copy of ``ultragrid_tpu/utils/log.py``.

Levels mirror the reference (quiet..debug2); ``MSG(level, ...)`` style is a
module-prefixed logger; rate-limited "once" variant included.
"""

from __future__ import annotations

import sys
import time
from typing import Set

LOG_LEVEL_QUIET = 0
LOG_LEVEL_FATAL = 1
LOG_LEVEL_ERROR = 2
LOG_LEVEL_WARNING = 3
LOG_LEVEL_NOTICE = 4
LOG_LEVEL_INFO = 5
LOG_LEVEL_VERBOSE = 6
LOG_LEVEL_DEBUG = 7
LOG_LEVEL_DEBUG2 = 8

_NAMES = {
    LOG_LEVEL_FATAL: "FATAL",
    LOG_LEVEL_ERROR: "ERROR",
    LOG_LEVEL_WARNING: "WARNING",
    LOG_LEVEL_NOTICE: "NOTICE",
    LOG_LEVEL_INFO: "INFO",
    LOG_LEVEL_VERBOSE: "VERBOSE",
    LOG_LEVEL_DEBUG: "DEBUG",
    LOG_LEVEL_DEBUG2: "DEBUG2",
}

_COLORS = {
    LOG_LEVEL_FATAL: "\033[1;31m",
    LOG_LEVEL_ERROR: "\033[31m",
    LOG_LEVEL_WARNING: "\033[33m",
    LOG_LEVEL_NOTICE: "\033[36m",
}

log_level = LOG_LEVEL_INFO
_use_color = sys.stderr.isatty()
_once_seen: Set[int] = set()


def set_log_level(level: int) -> None:
    global log_level
    log_level = level


def parse_log_level(spec: str) -> int:
    by_name = {v.lower(): k for k, v in _NAMES.items()}
    by_name["quiet"] = LOG_LEVEL_QUIET
    if spec.isdigit():
        return int(spec)
    return by_name.get(spec.lower(), LOG_LEVEL_INFO)


def log_msg(level: int, msg: str) -> None:
    if level > log_level:
        return
    color = _COLORS.get(level, "") if _use_color else ""
    reset = "\033[0m" if color else ""
    sys.stderr.write(f"{color}{msg}{reset}\n")
    sys.stderr.flush()


def log_msg_once(level: int, msg: str) -> None:
    """Rate-limited variant (ref: log_msg_once, debug.h)."""
    key = hash(msg)
    if key in _once_seen:
        return
    _once_seen.add(key)
    log_msg(level, msg)


class Logger:
    """Module-prefixed logger (ref: MSG() macro, debug.h:105-110)."""

    def __init__(self, mod_name: str):
        self.prefix = f"[{mod_name}] "

    def fatal(self, msg: str) -> None:
        log_msg(LOG_LEVEL_FATAL, self.prefix + msg)

    def error(self, msg: str) -> None:
        log_msg(LOG_LEVEL_ERROR, self.prefix + msg)

    def warning(self, msg: str) -> None:
        log_msg(LOG_LEVEL_WARNING, self.prefix + msg)

    def notice(self, msg: str) -> None:
        log_msg(LOG_LEVEL_NOTICE, self.prefix + msg)

    def info(self, msg: str) -> None:
        log_msg(LOG_LEVEL_INFO, self.prefix + msg)

    def verbose(self, msg: str) -> None:
        log_msg(LOG_LEVEL_VERBOSE, self.prefix + msg)

    def debug(self, msg: str) -> None:
        log_msg(LOG_LEVEL_DEBUG, self.prefix + msg)
