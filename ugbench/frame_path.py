"""A traced run of a cell, read along a frame's path.

    python3 -m ugbench.frame_path --workload <cell> --seed <n> [--seconds <s>]

Run from the repository's root on a machine with a CUDA device.  It runs
the cell as ``python3 -m ugbench.run ... --trace 1`` does and prints one
JSON line: the result line's fields (``correct``, the per-layer metrics, the
breakdown) and beside them ``latency_p50_ms`` of the traced run, the frame's
path (:func:`ugbench.spans.frame_path`: each segment's mean beside the
window's mean capture -> display latency), the clock check of K1's launches
against the ``compress.k1`` spans (:func:`ugbench.spans.clock_check`) and
each process's spans in the window by name, with their count and mean.
"""

import time

T_START_NS = time.monotonic_ns()  # noqa: E402 -- set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from ugbench import readings, registry, run, spans  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m ugbench.frame_path")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=None, help="default: the benchmark's run_seconds")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    bench = registry.benchmark()
    seconds = args.seconds or bench["run_seconds"]
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    run._caches()
    from ugbench import session

    started = session.start_child(cfg, traffic, True)
    import torch

    if not torch.cuda.is_available():
        session.stop_child(*started)
        print("ugbench.frame_path: no CUDA device", file=sys.stderr)
        return 2
    res = session.run_cell(cfg, traffic, args.seed, seconds, True, "cuda", T_START_NS, started=started)
    out = run.summarize(bench, cell, cfg, res, seconds, True, torch.cuda.get_device_name(0))
    line = run.result_line(out, res, cfg)
    line.update({"seed": args.seed, "latency_p50_ms": readings.latency_quantile_ms(res, 0.5),
                 "frame_path": spans.frame_path(res), "clock": spans.clock_check(res),
                 "window_spans": spans.window_spans(res)})
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
