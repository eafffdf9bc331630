"""A configuration, a traffic mix and a metric added as files are found by
name, with no edit to a file that is there."""

import json
import os
import shutil

from ugbench import registry


def test_files_added_to_a_copy_are_listed(tmp_path):
    copy = tmp_path / "ugbench"
    shutil.copytree(registry.HERE, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = (registry.list_configs(copy), registry.list_traffic(copy), registry.list_metrics(copy))
    cfg = registry.config("jpeg_ldgm_1080p")
    cfg["name"] = "jpeg_ldgm_720p"
    (copy / "configs" / "jpeg_ldgm_720p.json").write_text(json.dumps(cfg))
    tr = registry.traffic("cam24_loss1")
    tr["rate"] = 50
    (copy / "traffic" / "cam50_loss1.json").write_text(json.dumps(tr))
    (copy / "metrics" / "rx_display_ms.lat.py").write_text(
        "from ugbench import readings\n\nread = readings.zone_mean_ms('receiver', 'rx.display')\n")
    assert registry.list_configs(copy) == sorted(before[0] + ["jpeg_ldgm_720p"])
    assert registry.list_traffic(copy) == sorted(before[1] + ["cam50_loss1"])
    assert registry.list_metrics(copy) == sorted(before[2] + ["rx_display_ms.lat"])
    assert registry.config("jpeg_ldgm_720p", copy)["name"] == "jpeg_ldgm_720p"
    assert registry.traffic("cam50_loss1", copy)["rate"] == 50
    mod = registry.metric("rx_display_ms.lat", copy)
    assert mod.read({"t0_ns": 0, "seconds": 1.0, "zones": {"receiver": [("rx.display", 5, 2_000_000)]}}) == 2.0


def test_every_entry_of_the_benchmark_has_its_files():
    bench = registry.benchmark()
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(registry.ROOT, c["file"]))
        cfg = registry.config(c["name"])
        assert os.path.exists(os.path.join(registry.HERE, "checks", cfg["check"] + ".py"))
        assert set(registry.check_limits(cfg["check"]))
    for w in bench["workloads"]:
        registry.traffic(w["traffic"])
        names = [m["name"] for m in registry.cell_metrics(bench, w["name"], True)]
        assert names and all(n in registry.list_metrics() for n in names)
        e2e = [m["name"] for m in registry.cell_metrics(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
