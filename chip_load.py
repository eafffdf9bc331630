#!/usr/bin/env python3
"""Run a command several times on a loaded host: busy processes on some cores.

    python3 chip_load.py [--hogs N] [--runs K] -- <command> [arguments]

Starts N Python processes that spin (default: half the host's cores), runs
the command K times one after the other (default 3), and stops the spinning
processes at the end.  Prints one JSON line per run (exit code, seconds, the
UDP datagrams the kernel dropped for full receive buffers meanwhile, the last
lines of its output where it failed) and one summary line; ``--out`` keeps
each run's whole output.  Exits 0 when every run did.  It reads how a phase copes with a slow host, e.g.
``python3 chip_load.py -- python3 chip_smoke.py --only standards``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time


def _spin() -> None:
    while True:
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hogs", type=int, default=max(1, (os.cpu_count() or 2) // 2))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", help="directory for each run's whole output (run<i>.log)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    from chip_smoke import udp_rcvbuf_errors  # here: the spinning processes import this module
    cmd = a.command[1:] if a.command[:1] == ["--"] else a.command
    if not cmd:
        ap.error("no command given")
    ctx = multiprocessing.get_context("spawn")
    hogs = [ctx.Process(target=_spin, daemon=True) for _ in range(a.hogs)]
    for p in hogs:
        p.start()
    results = []
    try:
        for i in range(a.runs):
            t0, drops0 = time.perf_counter(), udp_rcvbuf_errors()
            r = subprocess.run(cmd, capture_output=True, text=True)
            row = {"run": i + 1, "rc": r.returncode, "seconds": time.perf_counter() - t0,
                   "udp_rcvbuf_errors": udp_rcvbuf_errors() - drops0, "hogs": a.hogs, "cpus": os.cpu_count()}
            if a.out:
                os.makedirs(a.out, exist_ok=True)
                with open(os.path.join(a.out, f"run{i + 1}.log"), "w") as fh:
                    fh.write(r.stdout + r.stderr)
            if r.returncode:
                row["tail"] = (r.stdout + r.stderr)[-3000:]
            results.append(row)
            print(json.dumps(row), flush=True)
    finally:
        for p in hogs:
            p.terminate()
        for p in hogs:
            p.join(5)
    ok = sum(r["rc"] == 0 for r in results)
    print(json.dumps({"command": cmd, "passed": ok, "runs": a.runs, "hogs": a.hogs}), flush=True)
    return 0 if ok == a.runs else 1


if __name__ == "__main__":
    sys.exit(main())
