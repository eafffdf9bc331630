"""The readers of the program's finer spans: each per-layer metric on a
hand-made run, None where its spans are missing (as at a program that does
not record them); the frame's path, the clock check and the idle
breakdown's choice of the finer span; and a tiny traced session on the CPU
whose real spans give every reader a number."""

import time

import pytest

from ugbench import readings, registry, session, spans, trace
from ugbench.tests import tiny

NS = 1_000_000_000
MS = 1_000_000

# metric -> (process, [(span, duration in ms)] a frame); two-span metrics sum
NEW = {
    "sender_queue_ms.lat": ("sender", [("compress.queue", 0.2), ("send.queue", 0.5)], 0.7),
    "sender_assemble_ms.lat": ("sender", [("compress.assemble", 1.5)], 1.5),
    "sender_fec_ms.lat": ("sender", [("tx.fec", 0.4)], 0.4),
    "rx_playout_ms.lat": ("receiver", [("rx.playout", 32.5)], 32.5),
    "rx_queue_ms.lat": ("receiver", [("fec.queue", 0.1), ("decompress.queue", 0.3)], 0.4),
    "rx_scan_decode_ms.lat": ("receiver", [("decompress.scan", 4.0)], 4.0),
    "rx_upload_ms.lat": ("receiver", [("decompress.upload", 1.25)], 1.25),
    "rx_peel_round_ms.lat": ("receiver", [("fec.peel.round", 0.6)], 0.6),
}


def hand_made(with_spans=True):
    t0 = 100 * NS
    zones = {"sender": [("compress", t0 + i * NS // 10, 3 * MS) for i in range(10)],
             "receiver": [("rx.fec", t0 + i * NS // 10, 2 * MS) for i in range(10)]}
    if with_spans:
        for proc, parts, _ in NEW.values():
            for name, ms in parts:
                zones[proc] += [(name, t0 + i * NS // 10 + 1, int(ms * MS)) for i in range(10)]
        # outside the window: not read
        zones["sender"].append(("compress.assemble", t0 + 5 * NS, 90 * MS))
    window = [(n, n, t0 + n * NS // 10, 0, 1000 + n) for n in range(10)]
    shown = {1000 + n: t0 + n * NS // 10 + 45 * MS for n in range(10)}
    return {"t0_ns": t0, "seconds": 1.0, "zones": zones, "window": window, "shown": shown,
            "t_drain_end_ns": t0 + 3 * NS, "device_slice": None, "kernels": {"sender": [], "receiver": []}}


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_new_metric_reads_its_spans(name):
    _, _, want = NEW[name]
    mod = registry.metric(name)
    assert mod.read(hand_made()) == pytest.approx(want)
    assert mod.read(hand_made(with_spans=False)) is None


def test_each_new_metric_is_declared_for_the_cells_it_reads():
    bench = registry.benchmark()
    declared = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert (m["source"], m["moves"], m["unit"]) == ("program_span", "latency_p50_ms", "ms")
        cells = ["jpeg1080p-live-loss"] if name == "rx_peel_round_ms.lat" else [
            "jpeg1080p-live-loss", "jpeg1080p-live-clean"]
        assert m["workloads"] == cells


def test_a_sum_needs_every_span():
    run = hand_made()
    run["zones"]["sender"] = [z for z in run["zones"]["sender"] if z[0] != "send.queue"]
    assert spans.frame_sum_ms("sender", ("compress.queue", "send.queue"))(run) is None


def test_frame_path_sums_the_segments_beside_the_latency():
    got = spans.frame_path(hand_made())
    seg = got["segments_ms"]
    assert seg["compress"] == pytest.approx(3.0) and seg["rx.playout"] == pytest.approx(32.5)
    assert seg["rx.display"] is None
    want = 0.2 + 3.0 + 0.5 + 0.4 + 32.5 + 0.1 + 2.0 + 0.3
    assert got["sum_ms"] == pytest.approx(want)
    assert got["latency_mean_ms"] == pytest.approx(45.0)
    assert got["remainder_ms"] == pytest.approx(45.0 - want)
    counted = spans.window_spans(hand_made())
    assert counted["sender"]["compress.assemble"] == [10, pytest.approx(1.5)]
    assert sum(n for n, _ in counted["sender"].values()) == 10 + 10 * 4
    assert sum(n for n, _ in counted["receiver"].values()) == 10 + 10 * 6


def test_clock_check_places_launches_inside_their_spans():
    t0 = 100 * NS
    run = hand_made()
    run["device_slice"] = (t0, t0 + NS)
    run["zones"]["sender"] = (
        [("compress", t0 + i * NS // 10, 3 * MS) for i in range(10)]
        + [("compress.k1", t0 + i * NS // 10 + 10_000, 200_000) for i in range(10)])
    # nine launches 30 us after their span's start, one after its compress
    run["kernels"]["sender"] = [("jpeg_encode_kernel<256, 256>", t0 + i * NS // 10 + 40_000, 50_000)
                                for i in range(9)] + [("jpeg_encode_kernel<256, 256>", t0 + 9 * NS // 10 + 4 * MS, 1)]
    got = spans.clock_check(run)
    assert got["launches"] == 10 and got["inside"] == 9 and got["share"] == pytest.approx(0.9)
    assert got["gap_median_us"] == pytest.approx(30.0) and got["gap_max_us"] == pytest.approx(30.0)
    run["device_slice"] = None
    assert spans.clock_check(run) is None


def test_idle_gap_inside_the_pacing_goes_to_it():
    # the send loop's span holds the host LDGM and then the paced send; a
    # device gap in the pacing is the pacing's
    zones = [("sender:fec+tx.send", 0, 40), ("sender:tx.fec", 1, 3), ("sender:tx.pace", 5, 34)]
    events = [("kernel", 0, 1), ("kernel", 38, 2)]
    got = dict(trace.idle_by_host(events, zones, 0, 40))
    assert set(got) == {"sender:tx.pace"}
    assert got["sender:tx.pace"] == pytest.approx(37 / NS)


def test_a_traced_tiny_session_gives_every_reader_a_number():
    cfg = tiny.config()
    bench = registry.benchmark()
    cell = registry.cell(bench, "jpeg1080p-live-loss")
    res = session.run_cell(cfg, tiny.traffic(cell["traffic"]), 2**32 + 91, 1.0, True, "cpu", time.monotonic_ns())
    res["seconds"] = 1.0
    for name in NEW:
        value = registry.metric(name).read(res)
        assert value is not None and value >= 0, name
    for name in ("sender_compress_ms.lat", "sender_tx_ms.lat", "rx_fec_ms.lat", "rx_decompress_ms.lat"):
        assert registry.metric(name).read(res) > 0, name
    path = spans.frame_path(res)
    assert all(v is not None for v in path["segments_ms"].values()), path
    assert path["latency_mean_ms"] > path["segments_ms"]["rx.playout"]
    # one record a frame of each span the existing metrics read
    lo, hi = readings.window(res)
    for proc, name in (("sender", "compress"), ("sender", "fec+tx.send"), ("receiver", "rx.fec"),
                       ("receiver", "rx.decompress")):
        n = sum(1 for z, s, _ in res["zones"][proc] if z == name and lo <= s < hi)
        assert 0 < n <= res["frames_window"] + 1, (name, n)
