"""The 8K configuration split by row band over four cards
(``jpeg_ldgm_8k_tiled``, ``--param cuda-device=0,1,2,3``), run whole at a
tiny size on the CPU, where the param's four cards map to four CPU
entries: a sound run is correct, and a fault in the sender, a fault in the
banded encoder and the control's TF32 plants are each found not correct."""

import time

import numpy as np
import pytest

from ugbench import control, registry, run, session
from ugbench.tests import faults, tiny

CELL = "jpeg8k-tiled4-live-clean"
CONFIG = "jpeg_ldgm_8k_tiled"


def one_run(cfg=None, child_setup=None, seconds=1.0, seed=2**32 + 81):
    cfg = cfg or tiny.config(CONFIG)
    bench = registry.benchmark()
    cell = registry.cell(bench, CELL)
    res = session.run_cell(cfg, tiny.traffic(cell["traffic"]), seed, seconds, False, "cpu",
                           time.monotonic_ns(), child_setup=child_setup)
    line = run.result_line(run.summarize(bench, cell, cfg, res, seconds, False, "cpu"), res, cfg)
    return line, res


def altered_band():
    """One byte of the third band's entropy-coded body is altered where its
    worker assembles it."""
    from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedJpegEncoder

    orig = ShardedJpegEncoder._encode_band

    def encode_band(self, s, band, frame_key):
        body = orig(self, s, band, frame_key)
        if s == 2:
            body[body.size // 2] ^= 0x5A
        return body

    ShardedJpegEncoder._encode_band = encode_band


def test_the_cell_is_declared_with_its_four_cards():
    bench = registry.benchmark()
    cell = registry.cell(bench, CELL)
    cfg = registry.config(CONFIG)
    assert cell["chips"] == 4 and cell["config"] == CONFIG
    assert cfg["params"]["cuda-device"] == "0,1,2,3" and (cfg["width"], cfg["height"]) == (7680, 4320)
    assert cfg["reduced"] == ["hosts", "udp_rcvbuf_bytes"] and cfg["check"] == "jpeg_ldgm"
    declared = next(c for c in bench["configs"] if c["name"] == CONFIG)
    assert declared["reduced"] == cfg["reduced"]
    names = {m["name"] for m in registry.cell_metrics(bench, CELL, True)}
    assert {"sender_split_ms.lat", "sender_band_ms.lat", "rx_band_ms.lat", "rx_gather_ms.lat",
            "k1_band_roofline_pct.lat", "rx_decompress_ms.lat", "rx_scan_decode_ms.lat",
            "rx_upload_ms.lat", "rx_rcvbuf_drops.lat", "cards_all_idle_pct.lat"} <= names
    assert not names & {"k1_roofline_pct.lat", "device_idle_pct.lat", "k2_roofline_pct.lat"}


def test_a_sound_run_is_correct_and_split():
    from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedJpegEncoder

    built = []
    init = ShardedJpegEncoder.__init__

    def track(self, *a, **kw):
        init(self, *a, **kw)
        built.append(self)

    ShardedJpegEncoder.__init__ = track
    try:
        line, res = one_run()
    finally:
        ShardedJpegEncoder.__init__ = init
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert built and all(e.nshards == 4 and len(e.devices) == 4 for e in built)


@pytest.mark.parametrize("fault", ["stale_sender", "half_packets", "altered_band"])
def test_a_fault_in_the_sender_is_not_correct(fault, monkeypatch):
    import ultragrid_tpu_torch.modules.video_compress as vc
    import ultragrid_tpu_torch.net.transmit as tx
    from ultragrid_tpu_torch.parallel import sharded_jpeg as sj

    monkeypatch.setattr(vc.JpegCompress, "compress", vc.JpegCompress.compress)
    monkeypatch.setattr(tx, "get_packet_sizes", tx.get_packet_sizes)
    monkeypatch.setattr(sj.ShardedJpegEncoder, "_encode_band", sj.ShardedJpegEncoder._encode_band)
    (altered_band if fault == "altered_band" else getattr(faults, fault))()
    line, _ = one_run()
    assert not line["correct"], line["checks"]


def test_a_fault_in_the_receiver_is_not_correct():
    line, _ = one_run(child_setup="ugbench.tests.faults:stale_receiver")
    assert not line["correct"], line["checks"]
    assert line["checks"]["pixel_off_ppm"]["value"] > line["checks"]["pixel_off_ppm"]["limit"]


def test_the_control_is_not_correct(monkeypatch):
    import ultragrid_tpu_torch.ops.jpeg as jp

    monkeypatch.setattr(jp.JpegEncoder, "_encode", jp.JpegEncoder._encode)
    control.tf32_sender()
    cfg = tiny.config(CONFIG)
    cfg.update(width=512, height=128)
    line, _ = one_run(cfg, child_setup="ugbench.control:tf32_receiver", seed=2**31 + 3)
    checks = line["checks"]
    assert not line["correct"]
    assert checks["coef_off_ppm"]["value"] > checks["coef_off_ppm"]["limit"], checks
    assert checks["pixel_off_ppm"]["value"] > checks["pixel_off_ppm"]["limit"], checks
    assert checks["frames_missing"]["value"] == 0


def test_the_band_roofline_reads_band_launches_only():
    NS = 1_000_000_000
    t0 = 100 * NS
    window = [(n, n, t0 + n * NS // 10, 0, 1000 + n) for n in range(10)]
    run_ = {"t0_ns": t0, "seconds": 1.0, "frame_size": (7680, 4320), "window": window,
            "sent": {1000 + n: (0, 1, 6_000_000, True) for n in range(10)},
            "device_slice": (t0, t0 + NS),
            "zones": {"sender": [("compress.band", t0 + i * NS // 40, 9_000_000) for i in range(40)]
                      + [("compress", t0 + i * NS // 10, 12_000_000) for i in range(10)],
                      "receiver": []},
            "kernels": {"sender": [("jpeg_encode_kernel<...>", t0 + i * NS // 40, 150_000) for i in range(40)],
                        "receiver": []}}
    k1 = registry.roofline("k1")
    got = registry.metric("k1_band_roofline_pct.lat").read(run_)
    assert got == pytest.approx(100 * k1.min_seconds(7680, 1080, 1_500_000) / 150e-6)
    # two bands a frame: the bound is half a frame's
    two = dict(run_, zones={"sender": run_["zones"]["sender"][:40:2] + run_["zones"]["sender"][40:],
                            "receiver": []})
    assert registry.metric("k1_band_roofline_pct.lat").read(two) == pytest.approx(
        100 * k1.min_seconds(7680, 2160, 3_000_000) / 150e-6)
    run_["zones"]["sender"] = []  # a program that encodes each frame in one launch
    assert registry.metric("k1_band_roofline_pct.lat").read(run_) is None
    for name, proc, span in (("sender_split_ms.lat", "sender", "compress.split"),
                             ("sender_band_ms.lat", "sender", "compress.band"),
                             ("rx_band_ms.lat", "receiver", "decompress.band"),
                             ("rx_gather_ms.lat", "receiver", "decompress.gather")):
        mod = registry.metric(name)
        assert mod.read(run_) is None
        run_["zones"][proc] = [(span, t0 + 5, 2_500_000)]
        assert mod.read(run_) == pytest.approx(2.5)
        run_["zones"] = {"sender": [], "receiver": []}
    assert np.isfinite(got)


def test_the_drops_and_idle_readers():
    NS = 1_000_000_000
    drops = registry.metric("rx_rcvbuf_drops.lat")
    assert drops.read({"child": {"rcvbuf_errors": 17, "rcvbuf_errors_at_window": 5}}) == 12.0
    assert drops.read({"child": {"rcvbuf_errors": -1, "rcvbuf_errors_at_window": -1}}) is None
    assert drops.read({"child": {"rcvbuf_errors": 3}}) is None
    idle = registry.metric("cards_all_idle_pct.lat")
    run_ = {"device_slice": (0, NS),
            "kernels": {"sender": [("k", 0, NS // 4), ("k", NS // 8, NS // 4)],
                        "receiver": [("d", NS // 2, NS // 4)]}}
    assert idle.read(run_) == pytest.approx(100 * (1 - 0.625))
    assert idle.read(dict(run_, kernels={"sender": [], "receiver": []})) is None
