"""The port's sender step (EncodePipeline) against the JAX reference's.

Same frames (numpy, from a seed) through the reference's jitted step on the
CPU and through ``ultragrid_tpu_torch.models.encode.EncodePipeline`` on the
CPU.  Tolerance: exact equality of all eight outputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from ultragrid_tpu.models import encode as ref_encode  # noqa: E402
from ultragrid_tpu.ops.fec import build_ldgm_matrix as ref_ldgm_matrix  # noqa: E402
from ultragrid_tpu.types import Codec, VideoDesc, vc_get_linesize  # noqa: E402
from ultragrid_tpu_torch import types as port_types  # noqa: E402
from ultragrid_tpu_torch.models import encode as port_encode  # noqa: E402

NAMES = ("ys", "ybits", "us", "ubits", "vs", "vbits", "parity", "overflow")


def content(w, h, codec, seed):
    ls = vc_get_linesize(w, codec)
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, ls, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


def assert_all_equal(ref_out, port_out, names=NAMES):
    assert len(ref_out) == len(port_out) == len(names)
    for name, a, b in zip(names, ref_out, port_out):
        a = np.asarray(a)
        b = b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), f"{name} differs"


def port_desc(w, h, codec=port_types.Codec.UYVY):
    return port_types.VideoDesc(w, h, port_types.Codec(codec), 30.0)


def pipelines(w, h, codec, sub, fec, quality=80):
    ref = ref_encode.EncodePipeline(VideoDesc(w, h, codec, 30.0), ref_encode.EncodeConfig(
        in_codec=codec, compress="jpeg", quality=quality, subsampling=sub, fec=fec))
    port = port_encode.EncodePipeline(port_desc(w, h, codec), port_encode.EncodeConfig(
        in_codec=port_types.Codec(codec), compress="jpeg", quality=quality, subsampling=sub, fec=fec),
        device="cpu")
    return ref, port


@pytest.mark.parametrize("w,h,codec,sub", [
    (256, 32, Codec.UYVY, None),
    (256, 64, Codec.UYVY, "420"),
    (256, 64, Codec.YUYV, "420"),
])
def test_pipeline_ldgm_matches_reference(w, h, codec, sub):
    ref, port = pipelines(w, h, codec, sub, "ldgm:32:16:5")
    assert port.fec_desc == ref.fec_desc
    frame = content(w, h, codec, 21)
    assert_all_equal(jax.tree.map(np.asarray, ref._step(frame)), port(frame))


def test_pipeline_without_fec_matches_reference():
    ref, port = pipelines(256, 32, Codec.UYVY, None, "none", quality=95)
    frame = content(256, 32, Codec.UYVY, 22)
    assert_all_equal(jax.tree.map(np.asarray, ref._step(frame)), port(frame),
                     names=NAMES[:6] + NAMES[7:])


def reference_arrays(ref_pipe, k, m, c):
    enc = ref_pipe.jpeg_encoder
    return {
        "_mega": enc._mega, "_dc_l": enc._dc_l, "_dc_c": enc._dc_c,
        "_ac_l": enc._ac_l, "_ac_c": enc._ac_c,
        "qtab_luma": enc.qtab_luma, "qtab_chroma": enc.qtab_chroma,
        "ldgm_mask": ref_ldgm_matrix(k, m, c, 1),
    }


def _state_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        va, vb = a[key], b[key]
        pairs = zip(va, vb) if isinstance(va, tuple) else [(va, vb)]
        for x, y in pairs:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), key


@pytest.mark.parametrize("sub", [None, "420"])
def test_state_from_reference_round_trip(sub):
    ref, port = pipelines(256, 64, Codec.UYVY, sub, "ldgm:32:16:5")
    loaded = port_encode.state_from_reference(reference_arrays(ref, 32, 16, 5))
    _state_equal(port.state, loaded)
    cfg = port_encode.EncodeConfig(compress="jpeg", subsampling=sub, fec="ldgm:32:16:5")
    on_loaded = port_encode.EncodePipeline(port_desc(256, 64), cfg, device="cpu", state=loaded)
    frame = content(256, 64, Codec.UYVY, 23)
    for a, b in zip(port(frame), on_loaded(frame)):
        assert torch.equal(a, b)


def test_loaded_state_is_what_runs():
    """A changed table in the loaded state changes the output: the pipeline
    reads its tables from the state, not from its own builders."""
    ref, port = pipelines(64, 16, Codec.UYVY, None, "ldgm:32:16:5")
    arrays = reference_arrays(ref, 32, 16, 5)
    W, const, bpr = arrays["_mega"]
    arrays["_mega"] = (W * 2, const * 2, bpr)
    cfg = port_encode.EncodeConfig(compress="jpeg", fec="ldgm:32:16:5")
    doubled = port_encode.EncodePipeline(port_desc(64, 16), cfg, device="cpu",
                                         state=port_encode.state_from_reference(arrays))
    frame = content(64, 16, Codec.UYVY, 24)
    assert not torch.equal(doubled(frame)[0], port(frame)[0])


@pytest.mark.parametrize("cfg,match", [
    (dict(compress="jpeg", fec="rs:200:240"), "ldgm only"),
    (dict(compress="h264"), "unknown compress"),
    (dict(compress="none", fec="mult:2"), "unsupported device FEC"),
])
def test_unported_options_raise(cfg, match):
    """Every option the reference accepts is ported; what it rejects (RS
    over the JPEG slot container, an unknown compress or device FEC)
    raises ValueError here too."""
    with pytest.raises(ValueError, match=match):
        port_encode.EncodePipeline(port_desc(128, 64), port_encode.EncodeConfig(**cfg), device="cpu")
    if cfg["compress"] == "jpeg":
        with pytest.raises(ValueError, match=match):
            ref_encode.EncodePipeline(VideoDesc(128, 64, Codec.UYVY, 30.0), ref_encode.EncodeConfig(**cfg))


FIXED = [  # (compress, in_codec, work_codec)
    ("none", Codec.UYVY, Codec.RGB), ("none", Codec.v210, Codec.UYVY), ("none", Codec.RGB, Codec.RGB),
    ("dxt1", Codec.UYVY, Codec.RGB), ("dxt1", Codec.RGB, Codec.RGB), ("dxt5", Codec.RGB, Codec.RGB),
]


def fixed_pipelines(w, h, compress, in_codec, work_codec, fec, state=None):
    ref = ref_encode.EncodePipeline(VideoDesc(w, h, in_codec, 30.0), ref_encode.EncodeConfig(
        in_codec=in_codec, work_codec=work_codec, compress=compress, fec=fec))
    port = port_encode.EncodePipeline(port_desc(w, h, in_codec), port_encode.EncodeConfig(
        in_codec=port_types.Codec(in_codec), work_codec=port_types.Codec(work_codec), compress=compress,
        fec=fec), device="cpu", state=state)
    return ref, port


@pytest.mark.parametrize("compress,in_codec,work_codec", FIXED, ids=[f"{c}-{i.name}" for c, i, _ in FIXED])
@pytest.mark.parametrize("fec", ["none", "ldgm:8:4:3", "rs:8:12"])
def test_fixed_size_pipeline_matches_reference(compress, in_codec, work_codec, fec):
    """compress none (conversion to work_codec), dxt1, dxt5, each with fec
    none, LDGM and RS: the payload and the parity equal the reference's."""
    ref, port = fixed_pipelines(64, 32, compress, in_codec, work_codec, fec)
    assert port.fec_desc == ref.fec_desc
    frame = content(64, 32, in_codec, 31)
    want = jax.tree.map(np.asarray, ref._step(frame))
    got = port(frame)
    if fec == "none":
        want, got = (want,), (got,)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert b.dtype == torch.uint8 and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(b.numpy(), a)


def test_fixed_size_ldgm_parity_is_the_host_sessions():
    """The fixed-size container's parity equals the host LdgmSession's
    parity bytes over the same payload (the wire layout)."""
    from ultragrid_tpu_torch.ops.fec import LdgmSession

    _, port = fixed_pipelines(64, 32, "dxt1", Codec.RGB, Codec.RGB, "ldgm:8:4:3")
    data, par = port(content(64, 32, Codec.RGB, 32))
    buf, desc = LdgmSession(8, 4, 3).encode(data.numpy())
    assert desc.symbol_size == port.ps
    np.testing.assert_array_equal(buf[8 * port.ps:].reshape(4, port.ps), par.numpy())


@pytest.mark.parametrize("fec", ["ldgm:8:4:3", "rs:8:12"])
def test_fixed_size_state_from_reference(fec):
    """A fixed-size pipeline computes with the reference's LDGM mask or RS
    bit matrix when given them, and a changed matrix changes the parity."""
    from ultragrid_tpu.ops.fec import _gf2_companion_expand as ref_bitmat

    arrays = {"ldgm_mask": ref_ldgm_matrix(8, 4, 3, 1)} if fec.startswith("ldgm") else \
        {"rs_bitmat": ref_bitmat(8, 12)}
    state = port_encode.state_from_reference(arrays)
    assert set(state) == set(arrays)
    ref, port = fixed_pipelines(64, 32, "dxt1", Codec.RGB, Codec.RGB, fec, state=state)
    frame = content(64, 32, Codec.RGB, 33)
    np.testing.assert_array_equal(port(frame)[1].numpy(), np.asarray(ref._step(frame)[1]))
    key = next(iter(arrays))
    changed = {key: np.roll(np.asarray(arrays[key]), 1, axis=1)}
    _, other = fixed_pipelines(64, 32, "dxt1", Codec.RGB, Codec.RGB, fec,
                               state=port_encode.state_from_reference(changed))
    assert not torch.equal(other(frame)[1], port(frame)[1])


@pytest.mark.parametrize("scale_to,sub", [((256, 128), None), ((128, 64), None), ((256, 256), "420")])
def test_scale_to_matches_reference(scale_to, sub):
    """The scale_to pre-scale (nearest neighbour) feeding the JPEG step."""
    w, h = 192, 96
    cfg = dict(compress="jpeg", fec="ldgm:32:16:5", scale_to=scale_to, subsampling=sub)
    ref = ref_encode.EncodePipeline(VideoDesc(w, h, Codec.UYVY, 30.0), ref_encode.EncodeConfig(**cfg))
    port = port_encode.EncodePipeline(port_desc(w, h), port_encode.EncodeConfig(**cfg), device="cpu")
    assert port.fec_desc == ref.fec_desc
    frame = content(w, h, Codec.UYVY, 34)
    assert_all_equal(jax.tree.map(np.asarray, ref._step(frame)), port(frame))


@pytest.mark.parametrize("pipe_dev,frame_dev", [("cpu", "meta"), ("meta", "cpu")])
def test_frame_on_another_device_raises(pipe_dev, frame_dev):
    """A tensor frame is never moved between devices behind the caller's
    back (a card frame copied to the host would skip the kernels)."""
    cfg = port_encode.EncodeConfig(compress="jpeg", fec="ldgm:32:16:5")
    pipe = port_encode.EncodePipeline(port_desc(64, 16), cfg, device=pipe_dev)
    frame = torch.zeros((16, 128), dtype=torch.uint8, device=frame_dev)
    with pytest.raises(ValueError, match=f"tensor is on {frame_dev}.*runs on {pipe_dev}"):
        pipe(frame)


def test_default_device_is_the_card():
    """Without a device the pipeline selects the card, and raises where
    there is none."""
    cfg = port_encode.EncodeConfig(compress="jpeg", fec="ldgm:32:16:5")
    if torch.cuda.is_available():
        assert port_encode.EncodePipeline(port_desc(64, 16), cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            port_encode.EncodePipeline(port_desc(64, 16), cfg)


def test_array_frame_goes_to_the_pipeline_device():
    cfg = port_encode.EncodeConfig(compress="jpeg", fec="ldgm:32:16:5")
    frame = content(64, 16, Codec.UYVY, 25)
    pipe = port_encode.EncodePipeline(port_desc(64, 16), cfg, device="cpu")
    for a, b in zip(pipe(frame), pipe(torch.as_tensor(frame))):
        assert a.device.type == "cpu" and torch.equal(a, b)


def test_container_params_match_reference():
    for size in (1, 1000, 4147200, 36 * 2**20):
        for k in (32, 256, 1500):
            assert port_encode.ldgm_container_params(size, k) == ref_encode.ldgm_container_params(size, k)
    for spec in ("none", "ldgm", "ldgm:256:26:5", "rs:200:240"):
        assert port_encode._parse_fec(spec) == ref_encode._parse_fec(spec)
