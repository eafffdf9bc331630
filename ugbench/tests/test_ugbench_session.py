"""Whole runs at a tiny size on the CPU, the look for a card skipped: a
sound run is correct, each fault planted in the timed path makes it not
correct, and a run that cannot hold what the benchmark demands is refused."""

import time

import pytest

from ugbench import registry, run, session
from ugbench.tests import faults, tiny

CELL = "jpeg1080p-live-loss"


def one_run(child_setup=None, seconds=1.0, cfg=None):
    cfg = cfg or tiny.config()
    bench = registry.benchmark()
    cell = registry.cell(bench, CELL)
    res = session.run_cell(cfg, tiny.traffic(cell["traffic"]), 2**32 + 77, seconds, False, "cpu",
                           time.monotonic_ns(), child_setup=child_setup)
    return bench, cell, cfg, res


def line_of(bench, cell, cfg, res, seconds=1.0):
    out = run.summarize(bench, cell, cfg, res, seconds, False, "cpu")
    return run.result_line(out, res, cfg)


def test_a_sound_run_is_correct():
    line = line_of(*one_run())
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", ["stale_sender", "half_packets", "altered_answer"])
def test_a_fault_in_the_sender_is_not_correct(fault, monkeypatch):
    import ultragrid_tpu_torch.modules.video_compress as vc
    import ultragrid_tpu_torch.net.transmit as tx
    import ultragrid_tpu_torch.ops.jpeg as jp

    monkeypatch.setattr(vc.JpegCompress, "compress", vc.JpegCompress.compress)
    monkeypatch.setattr(tx, "get_packet_sizes", tx.get_packet_sizes)
    monkeypatch.setattr(jp.JpegEncoder, "encode", jp.JpegEncoder.encode)
    getattr(faults, fault)()
    line = line_of(*one_run())
    assert not line["correct"], line["checks"]


def test_a_fault_in_the_receiver_is_not_correct():
    line = line_of(*one_run(child_setup="ugbench.tests.faults:stale_receiver"))
    assert not line["correct"], line["checks"]
    assert line["checks"]["pixel_off_ppm"]["value"] > line["checks"]["pixel_off_ppm"]["limit"]


def test_jax_loaded_by_the_receiver_refuses_the_run(capsys):
    bench, cell, cfg, res = one_run(child_setup="ugbench.tests.faults:receiver_loads_jax")
    assert res["child"]["forbidden"] == ["jax"]
    capsys.readouterr()
    assert run.report(bench, cell, cfg, res, 1.0, False, "cpu") != 0
    out = capsys.readouterr()
    assert out.out == "" and "loaded jax" in out.err


def test_a_receive_buffer_below_the_configuration_refuses_the_run():
    cfg = tiny.config()
    cfg["udp_rcvbuf_bytes"] = 1 << 30
    with pytest.raises(RuntimeError, match="udp_rcvbuf_bytes"):
        one_run(child_setup="ugbench.tests.faults:host_without_cap_net_admin", cfg=cfg)
