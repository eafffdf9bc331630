"""The benchmark's command: one run of one cell.

    python3 -m ugbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the repository's root on a machine with a CUDA device.  It loads
the cell from ``BENCHMARK.json``, its configuration and traffic mix from
``ugbench/configs`` and ``ugbench/traffic``, runs the port's live session
(:mod:`ugbench.session`), checks what the session produced against the
plain reference (``ugbench/checks``), prints each number compared beside
its limit as the last lines of standard error, and prints one JSON line as
the last line of standard output: the end-to-end metrics with ``--trace
0``, the per-layer metrics with ``--trace 1``.
"""

import time

T_START_NS = time.monotonic_ns()  # noqa: E402 -- set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from ugbench import child, readings, registry  # noqa: E402

NS = 1_000_000_000


def _parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m ugbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _caches() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    base = os.path.join(registry.HERE, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def end_to_end(name: str, res: dict, seconds: float):
    """An end-to-end metric of a run, by the host's clock."""
    t0 = res["t0_ns"]
    if name == "setup_s":
        return (t0 - res["t_start_ns"]) / NS
    if name.startswith("latency_p"):
        return readings.latency_quantile_ms(res, int(name[len("latency_p"):].split("_")[0]) / 100.0)
    raise KeyError(f"no end-to-end metric {name!r}")


def summarize(bench: dict, cell: dict, cfg: dict, res: dict, seconds: float, traced: bool,
              kind: str) -> dict:
    """The result line (without ``correct``'s checks) from a run's readings
    on the device named ``kind``."""
    from ugbench import trace

    res["seconds"] = seconds
    res["frame_size"] = (cfg["width"], cfg["height"])
    metrics = {}
    for m in registry.cell_metrics(bench, cell["name"], traced):
        if traced:
            v = registry.metric(m["name"]).read(res)
        else:
            v = end_to_end(m["name"], res, seconds)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell["chips"],
              "memory_peak_bytes": res["memory_peak_bytes"]}
    out = {"attempted": res["frames_window"], "metrics": metrics, "device": device}
    if traced:
        lo, hi = res["device_slice"] or readings.window(res)
        events = readings.merged_kernels(res)
        device["busy_s"] = trace.busy_seconds(events, lo, hi)
        device["window_s"] = (hi - lo) / NS
        out["breakdown"] = {"device_ops": trace.top_ops(events, lo, hi),
                            "idle_gaps": trace.idle_by_host(events, readings.merged_zones(res), lo, hi)}
    return out


def diagnosis(res: dict) -> str:
    """Where a run's frames stalled or went: the longest gaps between sends
    and between displays in the window, and the receiver's losses."""
    t0 = res["t0_ns"]
    hi = t0 + int(res["seconds"] * NS)

    def gap(times):
        ts = sorted(t for t in times if t0 <= t < hi)
        if len(ts) < 2:
            return "none"
        i = max(range(1, len(ts)), key=lambda j: ts[j] - ts[j - 1])
        return f"{(ts[i] - ts[i - 1]) / 1e6:.1f} ms at {(ts[i - 1] - t0) / NS:.2f} s"

    def pauses(proc):
        ev = [(d, g) for s, d, g in res["gc_pauses"][proc] if t0 <= s < hi]
        if not ev:
            return f"{proc} none"
        d, g = max(ev)
        return (f"{proc} {len(ev)}, {sum(x for x, _ in ev) / 1e6:.1f} ms in all, "
                f"the longest {d / 1e6:.1f} ms (generation {g})")

    ch = res["child"]
    return (f"garbage collections in the window: {pauses('sender')}; {pauses('receiver')}\n"
            f"longest gap: sends {gap(d for d, _, _, _ in res['sent'].values())}, "
            f"displays {gap(res['shown'].values())}; receiver: FEC jobs {ch.get('fec_jobs')}, "
            f"recovered {ch.get('fec_recovered')}, missing data {ch.get('frames_missing_data')}, "
            f"datagrams dropped by the host {ch.get('rcvbuf_errors')} "
            f"({ch.get('rcvbuf_errors_at_window')} of them before the window), "
            f"receive buffer {ch.get('rcvbuf_bytes')} B")


def result_line(out: dict, res: dict, cfg: dict) -> dict:
    """The printed line: ``correct`` from the configuration's check, its
    numbers beside their limits last."""
    numbers = registry.check(cfg["check"]).compare(res, cfg)
    limits = registry.check_limits(cfg["check"])
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    line = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
            "attempted": out["attempted"], "failed": numbers["frames_missing"],
            "metrics": out["metrics"], "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    return line


def forbidden(res: dict) -> list:
    """What either process of the run loaded of JAX or the JAX package,
    once the window had closed: this one's now, the receiver's as it
    reported."""
    return sorted(set(child.forbidden_loaded()) | set(res["child"].get("forbidden", [])))


def report(bench: dict, cell: dict, cfg: dict, res: dict, seconds: float, traced: bool, kind: str) -> int:
    """Check the run and print it: the numbers compared beside their limits
    as the last lines of standard error, the result as the last line of
    standard output.  Returns the exit code; a run that loaded JAX prints
    no result."""
    out = summarize(bench, cell, cfg, res, seconds, traced, kind)
    t_check = time.monotonic_ns()
    line = result_line(out, res, cfg)
    checks = line["checks"]
    print(f"check: {(time.monotonic_ns() - t_check) / NS:.3f} s over {len(res['buffers'])} frames", file=sys.stderr)
    found = forbidden(res)
    if found:
        print(f"ugbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    t_start = res["t_start_ns"]
    print("set-up: " + ", ".join(f"{k} {(v - t_start) / NS:.3f} s" for k, v in res["stages"].items()
                                 if v is not None and k != "trace_start_s"), file=sys.stderr)
    if "stages" in res["child"]:
        print("set-up of the second process: " + ", ".join(
            f"{k} {(v - t_start) / NS:.3f} s" for k, v in res["child"]["stages"].items()), file=sys.stderr)
    print(diagnosis(res), file=sys.stderr)
    if traced:
        print(f"profiler start: sender {res['stages'].get('trace_start_s')} s, "
              f"receiver {res['child'].get('trace_start_s')} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.config(cell["config"])
    traffic = registry.traffic(cell["traffic"])
    _caches()
    from ugbench import session

    # the second process imports and brings up the card while this one does
    started = session.start_child(cfg, traffic, bool(args.trace))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        session.stop_child(*started)
        print(f"ugbench: the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        res = session.run_cell(cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda", T_START_NS,
                               started=started)
    except RuntimeError as e:
        print(f"ugbench: {e}", file=sys.stderr)
        return 4
    return report(bench, cell, cfg, res, args.seconds, bool(args.trace), torch.cuda.get_device_name(0))


if __name__ == "__main__":
    sys.exit(main())
