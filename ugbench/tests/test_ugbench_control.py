"""The control (the timed path with TF32 products, ``ugbench/control.py``)
is found not correct by the benchmark's own check and result line, at a
size a test holds; ``python3 -m ugbench.control`` runs it on the card at
the cells' own sizes."""

import time

import numpy as np
import torch

from ugbench import content, control, registry, run, session
from ugbench.reference import jpeg as rjpeg
from ugbench.tests import tiny


def test_tf32_rounding():
    x = torch.tensor([1 + 2**-12, 1 + 2**-10, -(1 + 3 * 2**-11), 3.0e38, -0.0])
    got = control.tf32(x)
    assert got.tolist()[:3] == [1.0, 1 + 2**-10, -(1 + 2**-9)]
    assert control.tf32(got).equal(got) and torch.isfinite(got).all()


def test_the_control_computes_the_reference_in_tf32():
    f = content.ring(2**32 + 4, 256, 64, n=1, device="cpu")[0]
    ref, tol = rjpeg.forward_coefficients(f.numpy(), 80)
    assert np.array_equal(control.blocks_422(f).numpy(), rjpeg.blocks_422(f.numpy()))
    ctl = control.tf32_coefficients(f, 80).numpy()
    off = np.abs(ctl - ref) > 0.5 + tol
    assert off.any() and np.abs(ctl - ref).max() <= 1.5


def test_the_control_is_not_correct(monkeypatch):
    import ultragrid_tpu_torch.ops.jpeg as jp

    monkeypatch.setattr(jp.JpegEncoder, "_encode", jp.JpegEncoder._encode)
    control.tf32_sender()
    cfg = tiny.config()
    cfg.update(width=512, height=128)
    bench = registry.benchmark()
    cell = registry.cell(bench, "jpeg1080p-live-loss")
    res = session.run_cell(cfg, tiny.traffic(cell["traffic"]), 2**31 + 3, 1.0, False, "cpu",
                           time.monotonic_ns(), child_setup="ugbench.control:tf32_receiver")
    line = run.result_line(run.summarize(bench, cell, cfg, res, 1.0, False, "cpu"), res, cfg)
    checks = line["checks"]
    assert not line["correct"]
    assert checks["coef_off_ppm"]["value"] > checks["coef_off_ppm"]["limit"], checks
    assert checks["pixel_off_ppm"]["value"] > checks["pixel_off_ppm"]["limit"], checks
    assert checks["frames_missing"]["value"] == 0
