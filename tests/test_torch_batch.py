"""The port's batched JPEG sender against the JAX reference's and against its
own single-frame step.

``JpegBatchEncoder`` (B frames stacked row-wise, one K1 launch on the card)
and ``BatchedJpegLdgmPipeline`` (plus one K2 launch with a frame axis):
the same frames (numpy, from seeds) through the reference on the JAX CPU
and the port on the CPU.  Frames against the reference have at least 64
MCUs each (the CPU front end follows XLA's order from 64 MCUs on;
tests/test_torch_jpeg.py).  Tolerance: exact equality of every output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from ultragrid_tpu.models import encode as ref_encode  # noqa: E402
from ultragrid_tpu.ops.jpeg import JpegBatchEncoder as RefBatch  # noqa: E402
from ultragrid_tpu.types import Codec, VideoDesc, vc_get_linesize  # noqa: E402
from ultragrid_tpu_torch import types as pt  # noqa: E402
from ultragrid_tpu_torch.models import encode as port_encode  # noqa: E402
from ultragrid_tpu_torch.ops.fec import Gf2Parity, build_ldgm_matrix  # noqa: E402
from ultragrid_tpu_torch.ops.jpeg import JpegBatchEncoder, JpegEncoder  # noqa: E402


def content(w, h, codec, seed):
    ls = vc_get_linesize(w, codec)
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, ls, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


# (width, height, subsampling): 64 MCUs per frame in each
GEOMS = [(128, 64, None), (128, 128, "420")]


@pytest.mark.parametrize("w,h,sub", GEOMS, ids=["422", "420"])
def test_batch_encoder_files_match_reference_and_single(w, h, sub):
    frames = np.stack([content(w, h, Codec.UYVY, s) for s in range(3)])
    ref_files = RefBatch(w, h, 3, quality=80, subsampling=sub).encode(frames)
    enc = JpegBatchEncoder(w, h, 3, quality=80, subsampling=sub)
    files = enc.encode(frames, device="cpu")
    single = JpegEncoder(w, h, quality=80, subsampling=sub)
    assert len(files) == len(ref_files) == 3
    for f, r, frame in zip(files, ref_files, frames):
        np.testing.assert_array_equal(f, r)
        np.testing.assert_array_equal(f, single.encode(frame, device="cpu"))


def test_batch_encoder_escalation_moves_both_encoders():
    frames = np.random.default_rng(4).integers(0, 256, (2, 32, 128), dtype=np.uint8)
    enc = JpegBatchEncoder(64, 32, 2, quality=95)
    enc.tall.wwords = enc.single.wwords = 2
    files = enc.encode(torch.as_tensor(frames))
    assert enc.wwords > 2 and enc.single.wwords == enc.tall.wwords
    single = JpegEncoder(64, 32, quality=95)
    single.wwords = 2
    for f, frame in zip(files, frames):
        np.testing.assert_array_equal(f, single.encode(frame, device="cpu"))


def test_batch_encoder_rejects_a_restart_interval_across_frames():
    with pytest.raises(ValueError, match="restart interval"):
        JpegBatchEncoder(64, 16, 2, restart_interval=3)


NAMES = ("ys", "ybits", "us", "ubits", "vs", "vbits", "parity", "overflow")


@pytest.mark.parametrize("w,h,sub", GEOMS, ids=["422", "420"])
@pytest.mark.parametrize("nframes", [1, 3])
def test_batched_pipeline_matches_reference(w, h, sub, nframes):
    frames = np.concatenate([content(w, h, Codec.UYVY, 10 + s) for s in range(nframes)])
    ref = ref_encode.BatchedJpegLdgmPipeline(VideoDesc(w, h, Codec.UYVY, 30.0), nframes, quality=80,
                                             fec="ldgm:8:4:3", subsampling=sub)
    port = port_encode.BatchedJpegLdgmPipeline(pt.VideoDesc(w, h, pt.Codec.UYVY, 30.0), nframes, quality=80,
                                               fec="ldgm:8:4:3", subsampling=sub, device="cpu")
    assert port.ps == ref.ps and port.row_counts == ref.row_counts
    want = jax.tree.map(np.asarray, ref(frames))
    got = port(frames)
    for name, a, b in zip(NAMES, want, got):
        b = b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("sub", [None, "420"])
def test_batched_pipeline_equals_single_frame_steps(sub):
    """Per-frame outputs bit-identical to the single-frame EncodePipeline
    (64x32 frames, as tests/test_pipeline.py:532)."""
    w, h = 64, 32
    frames = [np.random.default_rng(s).integers(0, 256, (h, 2 * w), dtype=np.uint8) for s in range(3)]
    desc = pt.VideoDesc(w, h, pt.Codec.UYVY, 30.0)
    batch = port_encode.BatchedJpegLdgmPipeline(desc, 3, fec="ldgm:8:4:3", subsampling=sub, device="cpu")
    single = port_encode.EncodePipeline(desc, port_encode.EncodeConfig(
        compress="jpeg", subsampling=sub, fec="ldgm:8:4:3"), device="cpu")
    outs = batch(torch.as_tensor(np.stack(frames)))
    ky, npm = single.jpeg_encoder.ky, single.jpeg_encoder.nmcu
    for i, f in enumerate(frames):
        ref = single(f)
        sl, sc = slice(i * npm * ky, (i + 1) * npm * ky), slice(i * npm, (i + 1) * npm)
        for got, want in zip((outs[0][sl], outs[1][sl], outs[2][sc], outs[3][sc], outs[4][sc], outs[5][sc],
                              outs[6][i]), ref[:7]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("nframes", [1, 2, 5])
def test_gf2_parity_frame_axis_plain(nframes):
    """K2's plain version with a frame axis: frame f's parity is the
    single-frame parity of frame f's parts."""
    rng = np.random.default_rng(nframes)
    words = [40, 7, 12, 3]
    psw = 8
    rows = sum(-(-w // psw) for w in words)
    mask = build_ldgm_matrix(rows, 6, 3, 1)
    batch = Gf2Parity(mask, psw, part_words=words, frames=nframes)
    one = Gf2Parity(mask, psw, part_words=words)
    parts = [torch.as_tensor(rng.integers(-2**31, 2**31, nframes * w, dtype=np.int64).astype(np.int32))
             for w in words]
    got = batch(*parts)
    assert tuple(got.shape) == ((6, psw) if nframes == 1 else (nframes, 6, psw))
    got = got.reshape(nframes, 6, psw)
    for f in range(nframes):
        assert torch.equal(got[f], one(*[p[f * w: (f + 1) * w] for p, w in zip(parts, words)]))
    with pytest.raises(ValueError, match="parity input"):
        batch(*parts[:3])
    with pytest.raises(ValueError, match="parity input"):
        batch(*[torch.cat([p, p[:1]]) for p in parts])


def test_batched_pipeline_rejects_other_fec():
    with pytest.raises(ValueError, match="ldgm"):
        port_encode.BatchedJpegLdgmPipeline(pt.VideoDesc(64, 32, pt.Codec.UYVY), 2, fec="rs:8:12", device="cpu")
