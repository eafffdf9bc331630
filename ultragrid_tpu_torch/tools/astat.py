"""astat — audio level meter over the control socket.

Parity with the reference's tools/astat.cpp: connects to a running session's
control port, subscribes to stats, parses ``stats A... volrmsN/volpeakN``
lines and reports the running peak/RMS per channel.

Usage: python -m ultragrid_tpu_torch.tools.astat [host[:port]] [--seconds N]

The port's copy of ``ultragrid_tpu/tools/astat.py``.
"""

from __future__ import annotations

import argparse
import socket
import sys
import time

from ultragrid_tpu_torch.audio.volume import parse_stats_line
from ultragrid_tpu_torch.utils.control_socket import DEFAULT_CONTROL_PORT


def run(host: str = "127.0.0.1", port: int = DEFAULT_CONTROL_PORT,
        seconds: float = 5.0, out=sys.stdout) -> dict:
    peaks: dict = {}
    with socket.create_connection((host, port), timeout=5) as sock:
        sock.sendall(b"stats on\r\n")
        sock.settimeout(0.5)
        deadline = time.monotonic() + seconds
        buf = b""
        while time.monotonic() < deadline:
            try:
                chunk = sock.recv(4096)
            except socket.timeout:
                continue
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                stats = parse_stats_line(line.decode(errors="replace").strip())
                if stats:
                    for ch, (rms, peak) in stats.items():
                        prev = peaks.get(ch, (-999.0, -999.0))
                        peaks[ch] = (max(prev[0], rms), max(prev[1], peak))
    for ch in sorted(peaks):
        rms, peak = peaks[ch]
        print(f"ch{ch}: rms {rms:.2f} dBFS, peak {peak:.2f} dBFS", file=out)
    return peaks


def main() -> int:
    ap = argparse.ArgumentParser(description="audio level meter (control socket client)")
    ap.add_argument("target", nargs="?", default="127.0.0.1")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args()
    host, _, port = args.target.partition(":")
    run(host or "127.0.0.1", int(port) if port else DEFAULT_CONTROL_PORT, args.seconds)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
