"""The stage ablation of the port's P-frame graph (``make_device_encode_p``'s
``_stop_after``) against the JAX package's on the CPU, at 64x48 qp 26.

Each of the five exits returns the reference's tuple, tensor for tensor:
the same shapes, dtypes and values (all of it is integer work, so no
tolerance).  Without ``_stop_after`` the graph gives the reference's whole
outputs, as before.  The content is a panned picture with chroma that moves
too, so every stage has motion to find.  Each reference graph is built once
per module (``tests/torch_h264_helpers.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ultragrid_tpu.ops import h264 as ref_h264  # noqa: E402
from ultragrid_tpu.ops import h264_tpu  # noqa: E402

from ultragrid_tpu_torch.ops.h264_device import STOP_STAGES, make_device_encode_p  # noqa: E402

from tests.torch_h264_helpers import moving, shared_reference_graphs  # noqa: E402,F401

W, H, QP = 64, 48, 26


def planes():
    """(y, cb, cr) of the second frame and (ry, rcb, rcr) of the first of a
    picture panned 3 samples right and 1 down, padded to whole macroblocks."""
    f0, f1 = moving(2, W, H, step=3, seed=5)
    ref = ref_h264._pad_to_mb(*ref_h264.uyvy_to_i420(f0, W, H))
    cur = ref_h264._pad_to_mb(*ref_h264.uyvy_to_i420(f1, W, H))
    return tuple(cur) + tuple(ref)


def both(stage, search=8, subpel="half"):
    args = planes()
    want = h264_tpu.make_device_encode_p(W, H, QP, search, wwords=32, _stop_after=stage, subpel=subpel)(*args)
    got = make_device_encode_p(W, H, QP, search, wwords=32, _stop_after=stage, subpel=subpel,
                               device="cpu")(*(torch.as_tensor(a) for a in args))
    return [np.asarray(w) for w in want], list(got)


def assert_same(want, got):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        g = g.numpy()
        assert w.shape == g.shape and w.dtype == g.dtype, (i, w.shape, g.shape, w.dtype, g.dtype)
        assert np.array_equal(w, g), i


@pytest.mark.parametrize("stage", STOP_STAGES)
def test_each_stage_equals_the_reference(stage):
    want, got = both(stage)
    assert_same(want, got)
    if stage != "coarse" and stage != "extract":
        assert np.any(want[-2] != 0), "no motion found: the stage was not exercised"


def test_quarter_pel_stops_after_its_refine():
    """With quarter-pel the "halfpel" exit comes after the quarter refine,
    as in the reference."""
    want, got = both("halfpel", search=8, subpel="quarter")
    assert_same(want, got)
    assert np.any(want[1] % 2 != 0), "no quarter-sample vector"


def test_without_a_search_only_the_residual_exit_is_reached():
    want, got = both("residual", search=0)
    assert_same(want, got)
    assert not np.any(want[2]) and not np.any(want[3])


def test_no_stop_keeps_the_whole_graph():
    """``_stop_after=None``: words, bit counts, overflow and the
    reconstruction equal the reference's whole graph."""
    want, got = both(None)
    assert len(want) == len(got) == 6
    for i, (w, g) in enumerate(zip(want, got)):
        assert np.array_equal(w.astype(np.int64), g.numpy().astype(np.int64)), i


def test_an_unknown_stage_raises():
    with pytest.raises(ValueError, match="_stop_after"):
        make_device_encode_p(W, H, QP, _stop_after="pack", device="cpu")
