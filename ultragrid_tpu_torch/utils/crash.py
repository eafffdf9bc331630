"""Crash reporting + exit watchdog (ref: src/host.cpp:1286-1447
crash_signal_handler/print_backtrace; src/main.cpp:1438 exit watchdog); the
port's copy of ``ultragrid_tpu/utils/crash.py``.

The reference installs signal handlers that print a backtrace and a
bug-report pointer, and arms a watchdog that force-exits the process when a
clean shutdown hangs (a stuck capture/display thread must not wedge the
session forever).
"""

from __future__ import annotations

import faulthandler
import os
import signal
import sys
import threading

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("crash")

WATCHDOG_GRACE_S = 10.0  # ref: main.cpp exit watchdog timeout


def install_crash_handler() -> None:
    """Dump Python tracebacks of all threads on fatal signals
    (SIGSEGV/SIGFPE/SIGABRT/SIGBUS/SIGILL), like the reference's
    crash_signal_handler backtrace."""
    try:
        faulthandler.enable(all_threads=True)
    except Exception:  # noqa: BLE001 - e.g. stderr without fileno (embedders)
        return

    def _report(sig, frame):  # SIGTERM/SIGHUP: report, then default action
        sys.stderr.write(
            f"\nultragrid_tpu_torch terminating on signal {sig}; "
            "please report bugs with the traceback above.\n"
        )
        signal.signal(sig, signal.SIG_DFL)
        os.kill(os.getpid(), sig)

    for s in (signal.SIGTERM,):
        try:
            signal.signal(s, _report)
        except (ValueError, OSError):
            pass  # not main thread / unsupported


def arm_exit_watchdog(grace: float = WATCHDOG_GRACE_S) -> threading.Timer:
    """Call when a clean shutdown starts: if the process is still alive
    after `grace` seconds, print the thread dump and force-exit
    (ref: main.cpp:1438)."""

    def _fire() -> None:
        sys.stderr.write(
            f"exit watchdog: shutdown did not complete within {grace:.0f}s, "
            "forcing exit; thread dump follows\n"
        )
        faulthandler.dump_traceback(all_threads=True)
        os._exit(2)

    t = threading.Timer(grace, _fire)
    t.daemon = True
    t.start()
    return t
