"""What the benchmark is made of, found by name in its folders.

``BENCHMARK.json`` names the cells; each cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``); each
per-layer metric is a module ``metrics/<name>.py`` with ``read(run)``; each
kernel's roofline count is ``rooflines/<kernel>.py``; each configuration
names its correctness check ``checks/<name>.py`` with its limits in
``checks/<name>.json``.  A later change adds a file and an entry, and edits
none of these.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _names(folder: str, ext: str, root: str = HERE):
    d = os.path.join(root, folder)
    return sorted(f[: -len(ext)] for f in os.listdir(d) if f.endswith(ext) and not f.startswith("_"))


def list_configs(root: str = HERE):
    return _names("configs", ".json", root)


def list_traffic(root: str = HERE):
    return _names("traffic", ".json", root)


def list_metrics(root: str = HERE):
    return _names("metrics", ".py", root)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def config(name: str, root: str = HERE) -> dict:
    return _json(os.path.join(root, "configs", f"{name}.json"))


def traffic(name: str, root: str = HERE) -> dict:
    return _json(os.path.join(root, "traffic", f"{name}.json"))


def check_limits(name: str, root: str = HERE) -> dict:
    return _json(os.path.join(root, "checks", f"{name}.json"))


def _module(folder: str, name: str, root: str = HERE) -> ModuleType:
    path = os.path.join(root, folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ugbench.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str, root: str = HERE) -> ModuleType:
    return _module("metrics", name, root)


def roofline(kernel: str, root: str = HERE) -> ModuleType:
    return _module("rooflines", kernel, root)


def check(name: str, root: str = HERE) -> ModuleType:
    return _module("checks", name, root)


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool):
    """The metric entries a run of ``workload`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]
