import pytest

from ugbench import readings, registry, run, session, trace

NS = 1_000_000_000


def fake_run():
    t0 = 100 * NS
    window = [(n, n % 60, t0 + n * NS // 10, 0, 1000 + n) for n in range(20)]
    shown = {1000 + n: t0 + n * NS // 10 + (n + 1) * 1_000_000 for n in range(19)}  # the last never shown
    sent = {1000 + n: (t0 + n * NS // 10 + 5_000_000, 1, 400_000, True) for n in range(20)}
    return {"t0_ns": t0, "t_start_ns": t0 - 7 * NS, "window": window, "shown": shown, "sent": sent,
            "t_drain_end_ns": t0 + 10 * NS, "seconds": 2.0, "frame_size": (1920, 1080),
            "zones": {"sender": [("compress", t0 + i * NS // 10, 3_000_000) for i in range(25)],
                      "receiver": []},
            "kernels": {"sender": [("jpeg_encode_kernel<...>", t0 + i * NS // 10, 50_000) for i in range(20)],
                        "receiver": [("gf2_parity_kernel", t0 + i * NS // 10 + 1_000_000, 10_000)
                                     for i in range(10)]},
            "device_slice": (t0, t0 + 2 * NS),
            "child": {"peels": [(t0 + i * NS // 10, 1500, 256, 26, 1280, 1) for i in range(10)]}}


def test_tail_is_over_every_frame_and_missing_frames_wait_to_the_end():
    res = fake_run()
    lat = sorted([(n + 1) for n in range(19)] + [10_000 - 1900])  # ms; the missing frame waited
    assert run.end_to_end("latency_p50_ms", res, 2.0) == pytest.approx(lat[9])
    assert run.end_to_end("latency_p95_ms", res, 2.0) == pytest.approx(lat[18])
    assert session.quantile(range(1, 101), 0.95) == 95
    assert registry.metric("latency_p95_ms.tail").read(res) == pytest.approx(lat[18])
    assert run.end_to_end("setup_s", res, 2.0) == pytest.approx(7.0)


def test_forbidden_names_are_compared_whole():
    from ugbench import child

    assert child.forbidden_loaded(["ultragrid_tpu_torch.ops.jpeg", "jaxtyping", "torch"]) == []
    assert child.forbidden_loaded(["ultragrid_tpu.ops", "jax.numpy", "flax"]) == ["flax", "jax", "ultragrid_tpu"]
    res = fake_run()
    res["child"]["forbidden"] = ["jaxlib"]
    assert "jaxlib" in run.forbidden(res)


def test_zone_mean_reads_the_window_only():
    res = fake_run()
    assert readings.zone_mean_ms("sender", "compress")(res) == pytest.approx(3.0)
    res["seconds"] = 1.0
    assert readings.zone_mean_ms("sender", "compress")(res) == pytest.approx(3.0)
    assert readings.zone_mean_ms("receiver", "rx.fec")(res) is None


def test_rooflines_and_idle():
    res = fake_run()
    k1 = registry.roofline("k1").min_seconds(1920, 1080, 400_000)
    assert readings.k1_roofline(res) == pytest.approx(100 * k1 / 50e-6)
    k2 = registry.roofline("k2").peel_launch(1500, 256, 26, 1280)
    assert readings.k2_roofline(res) == pytest.approx(100 * k2 / 10e-6)
    busy = (20 * 50_000 + 10 * 10_000) / NS
    assert readings.device_idle(res) == pytest.approx(100 * (1 - busy / 2.0))
    res["kernels"] = {"sender": [], "receiver": []}
    assert readings.k1_roofline(res) is None and readings.device_idle(res) is None


def test_union_and_idle_attribution():
    ev = [("a", 0, 10), ("b", 5, 10), ("c", 30, 5)]
    assert trace.union(ev, 0, 100) == [[0, 15], [30, 35]]
    assert trace.busy_seconds(ev, 0, 100) == pytest.approx(20 / NS)
    zones = [("s:x", 14, 20), ("s:y", 40, 100)]
    got = dict(trace.idle_by_host(ev, zones, 0, 100))
    assert got == pytest.approx({"s:x": 15 / NS, "s:y": 65 / NS})
