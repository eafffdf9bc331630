"""The port's wavelet codecs against the JAX package on the CPU: JPEG XS
(``ops/jpegxs.py``, the 5/3 DWT) and CineForm's UCF1 container
(``ops/cineform.py``, the 2/6 wavelet), and their compress and decompress
modules.

The DWTs are integer lifting (int32, arithmetic shifts): the bands, the
streams and the decoded planes are equal to the reference's, byte for
byte, with no tolerance.  Inputs are made from a seed with numpy.
"""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules.video_compress import compress_init as ref_compress_init  # noqa: E402
from ultragrid_tpu.modules.video_decompress import decompress_init as ref_decompress_init  # noqa: E402
from ultragrid_tpu.ops import cineform as ref_cf  # noqa: E402
from ultragrid_tpu.ops import jpegxs as ref_xs  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch.modules.video_compress import compress_init  # noqa: E402
from ultragrid_tpu_torch.modules.video_decompress import decompress_init  # noqa: E402
from ultragrid_tpu_torch.ops import cineform, jpegxs  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

from tests.torch_h264_helpers import picture  # noqa: E402

# the reference tests' golden digests (tests/test_jpegxs.py:88,
# tests/test_cineform.py:92): the streams of their fixed inputs
XS_GOLDEN = "20621eebdd37a4bb2b2d684f181ea0440a63541f3fd0d5412e8db1c3b1cc1d55"
CF_GOLDEN = "6ecbfc71735be76a97dd97bb9d97aaf248c07f18cea7dedd63eba13d135b459d"


REF_DWT53 = (ref_xs.dwt53_forward, ref_xs.dwt53_inverse)
REF_DWT26 = (ref_cf.dwt26_forward, ref_cf.dwt26_inverse)


def _names53(nlx, nly):
    return (["HL1v", "LH1v"] if nly else []) + [f"H{lev}" for lev in range(1, nlx + 1)] + ["LL"]


def _names26(levels):
    return ["LL"] + [f"L{lvl}{b}" for lvl in range(levels, 0, -1) for b in ("LH", "HL", "HH")]


@pytest.fixture(scope="module", autouse=True)
def jitted_reference_transforms():
    """The reference runs its DWTs op by op, and on the CPU each op compiles
    once per shape (seconds per plane shape); this file takes each DWT
    jitted whole, one compile per shape.  The DWTs are integer ops only, so
    their outputs are the same integers.  (A band list
    holds names, which a jitted function cannot return: the names are put
    back in the reference's order.)"""
    import jax

    mp = pytest.MonkeyPatch()
    for mod, (fwd, inv), names in ((ref_xs, REF_DWT53, _names53), (ref_cf, REF_DWT26, _names26)):
        fwd_j = jax.jit(lambda plane, *lv, fwd=fwd: tuple(b for _, b in fwd(plane, *lv)),
                        static_argnums=tuple(range(1, 1 + len(names.__code__.co_varnames))))
        inv_j = jax.jit(lambda bands, *lv, inv=inv: inv(list(bands.items()), *lv),
                        static_argnums=tuple(range(1, 1 + len(names.__code__.co_varnames))))
        mp.setattr(mod, fwd.__name__, lambda plane, *lv, fwd_j=fwd_j, names=names: list(zip(names(*lv),
                                                                                            fwd_j(plane, *lv))))
        mp.setattr(mod, inv.__name__, lambda bands, *lv, inv_j=inv_j: inv_j(dict(bands), *lv))
    yield
    mp.undo()


def _rand(shape, seed, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


def _smooth(h, w):
    return ((np.indices((h, w)).sum(axis=0) * 2) % 256).astype(np.int32)


def _host(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _same_bands(port_bands, ref_bands):
    assert [n for n, _ in port_bands] == [n for n, _ in ref_bands]
    for (name, p), (_, r) in zip(port_bands, ref_bands):
        assert p.dtype == torch.int32
        assert np.array_equal(p.numpy(), np.asarray(r)), name


# ---------------------------------------------------------------------------
# the device stages
# ---------------------------------------------------------------------------

# (shape, nlx, nly): even sizes, odd heights (nly = 0), and bands one sample
# wide at the deepest level (8 >> 3)
DWT53_CASES = [((16, 64), 1, 0), ((16, 64), 3, 0), ((16, 64), 3, 1), ((16, 64), 5, 1), ((37, 24), 3, 0),
               ((6, 8), 3, 1), ((2, 2), 1, 1), ((1, 16), 4, 0), ((48, 40), 3, 1)]


@pytest.mark.parametrize("shape,nlx,nly", DWT53_CASES)
def test_dwt53_bands_equal_reference(shape, nlx, nly):
    plane = _rand(shape, sum(shape) + nlx, -512, 512)
    bands = jpegxs.dwt53_forward(torch.as_tensor(plane), nlx, nly)
    ref = ref_xs.dwt53_forward(jnp.asarray(plane), nlx, nly)
    _same_bands(bands, ref)
    rec = jpegxs.dwt53_inverse(bands, nlx, nly)
    assert np.array_equal(rec.numpy(), np.asarray(ref_xs.dwt53_inverse(ref, nlx, nly)))
    assert np.array_equal(rec.numpy(), plane)


# (shape, levels): 1-wide LL at 3 levels (8 >> 3), odd band sizes (24 >> 3 = 3,
# 40 >> 3 = 5), a tall plane
DWT26_CASES = [((32, 64), 1), ((32, 64), 2), ((32, 64), 3), ((8, 8), 3), ((24, 40), 3), ((64, 8), 3), ((2, 2), 1)]


@pytest.mark.parametrize("shape,levels", DWT26_CASES)
def test_dwt26_bands_equal_reference(shape, levels):
    plane = _rand(shape, sum(shape) + levels, -2048, 2048)
    bands = cineform.dwt26_forward(torch.as_tensor(plane), levels)
    ref = ref_cf.dwt26_forward(jnp.asarray(plane), levels)
    _same_bands(bands, ref)
    rec = cineform.dwt26_inverse(bands, levels)
    assert np.array_equal(rec.numpy(), np.asarray(ref_cf.dwt26_inverse(ref, levels)))
    assert np.array_equal(rec.numpy(), plane)


def test_pad_edge_is_numpy_edge_padding():
    plane = _rand((5, 7), 3)
    got = jpegxs.pad_edge(torch.as_tensor(plane), 8, 16).numpy()
    assert np.array_equal(got, np.pad(plane, ((0, 3), (0, 9)), mode="edge"))


# ---------------------------------------------------------------------------
# streams and decoded planes
# ---------------------------------------------------------------------------

# the cases of tests/test_jpegxs.py and test_cineform.py, and more: planes,
# quality
PLANE_SETS = {
    "422": [_rand((48, 64), 1), _rand((48, 32), 2), _rand((48, 32), 3)],
    "400-smooth": [_smooth(48, 64)],
    "400-odd": [_rand((37, 53), 5)],
    "444-odd": [_rand((37, 53), 6), _rand((37, 53), 7), _rand((37, 53), 8)],
    "10-bit": [_rand((48, 64), 9, 0, 1024)],
}
XS_CASES = [(k, q, 3, 1) for k in PLANE_SETS for q in (100, 90, 70)] + [("400-smooth", 50, 5, 0)]


@pytest.mark.parametrize("planes,quality,nlx,nly", XS_CASES, ids=[f"{k}-q{q}-{a}{b}" for k, q, a, b in XS_CASES])
def test_jpegxs_stream_and_planes_equal_reference(planes, quality, nlx, nly):
    planes = PLANE_SETS[planes]
    stream = jpegxs.JpegXsCodec(nlx, nly, quality, device="cpu").encode_planes(planes)
    ref_stream = ref_xs.JpegXsCodec(nlx, nly, quality).encode_planes(planes)
    assert stream == ref_stream
    got = jpegxs.JpegXsCodec(device="cpu").decode_planes(stream)
    want = ref_xs.JpegXsCodec().decode_planes(stream)
    assert len(got) == len(want) == len(planes)
    for g, w, p in zip(got, want, planes):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
        if quality == 100:
            assert np.array_equal(g.numpy(), p)


CF_CASES = [(k, q, 3) for k in PLANE_SETS for q in (100, 90, 60)] + [("400-smooth", 30, 2)]


@pytest.mark.parametrize("planes,quality,levels", CF_CASES, ids=[f"{k}-q{q}-l{lv}" for k, q, lv in CF_CASES])
def test_ucf1_stream_and_planes_equal_reference(planes, quality, levels):
    planes = PLANE_SETS[planes]
    stream = cineform.CineformCodec(levels, quality, device="cpu").encode_planes(planes)
    assert stream == ref_cf.CineformCodec(levels, quality).encode_planes(planes)
    got = cineform.CineformCodec(device="cpu").decode_planes(stream)
    want = ref_cf.CineformCodec().decode_planes(stream)
    for g, w, p in zip(got, want, planes):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
        if quality == 100:
            assert np.array_equal(g.numpy(), p)


def test_ucf1_long_zero_runs_take_escape_tokens_as_the_reference():
    """A flat 256x256 plane: its high bands are zero runs longer than the
    entropy layer's cap of 16,383, which spill into escape tokens."""
    plane = np.full((256, 256), 77, np.int32)
    plane[200, 3] = 90
    stream = cineform.CineformCodec(device="cpu").encode_planes([plane])
    assert stream == ref_cf.CineformCodec().encode_planes([plane])
    assert np.array_equal(cineform.CineformCodec(device="cpu").decode_planes(stream)[0].numpy(), plane)


def test_golden_digests():
    plane = (np.arange(32 * 48, dtype=np.int64).reshape(32, 48) % 251).astype(np.int32)
    xs = jpegxs.JpegXsCodec(nlx=3, nly=1, quality=90, device="cpu").encode_planes([plane])
    cf = cineform.CineformCodec(levels=3, quality=90, device="cpu").encode_planes([plane])
    assert hashlib.sha256(xs).hexdigest() == XS_GOLDEN
    assert hashlib.sha256(cf).hexdigest() == CF_GOLDEN
    assert np.abs(jpegxs.JpegXsCodec(device="cpu").decode_planes(xs)[0].numpy() - plane).max() <= 4
    assert np.abs(cineform.CineformCodec(device="cpu").decode_planes(cf)[0].numpy() - plane).max() <= 16


def test_codec_takes_tensors_on_its_device_only():
    codec = jpegxs.JpegXsCodec(device="cpu")
    plane = torch.as_tensor(_rand((16, 16), 4))
    assert codec.encode_planes([plane]) == codec.encode_planes([plane.numpy()])
    with pytest.raises(ValueError):
        codec.encode_planes([plane.to("meta")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            jpegxs.JpegXsCodec()
        with pytest.raises(RuntimeError):
            cineform.CineformCodec()


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

# (width, height, content, codec): the bars of the reference's tests, a
# picture at odd sizes (CineForm takes UCF1 there), RGB input (converted)
FRAMES = [(128, 64, "bars", Codec.UYVY), (70, 38, "picture", Codec.UYVY), (128, 64, "noise", Codec.RGB)]
MODULE_SPECS = ["jpegxs", "jpegxs:100", "jpegxs:80", "cineform", "cineform:100", "cineform:80"]


def _frame(w, h, kind, codec):
    if kind == "bars":
        data = np.asarray(generate_pattern(w, h, codec, "bars", device="cpu"))
    elif codec == Codec.UYVY:
        data = picture(w, h, w + h)
    else:
        data = np.random.default_rng(w).integers(0, 256, (h, 3 * w), dtype=np.uint8)
    return data


@pytest.mark.parametrize("spec", MODULE_SPECS)
@pytest.mark.parametrize("w,h,kind,codec", FRAMES, ids=[f"{w}x{h}-{k}-{c.name}" for w, h, k, c in FRAMES])
def test_modules_equal_reference(spec, w, h, kind, codec):
    data = _frame(w, h, kind, codec)
    comp = compress_init(spec, device="cpu").compress(VideoFrame(VideoDesc(w, h, codec, 30.0), [torch.as_tensor(data)],
                                                                 1.5))
    ref = ref_compress_init(spec).compress(RefFrame(RefDesc(w, h, RefCodec(int(codec)), 30.0), [data]))
    assert int(comp.desc.color_spec) == int(ref.desc.color_spec) and comp.timestamp == 1.5
    assert bytes(_host(comp.data)) == bytes(np.asarray(ref.data))
    dec, out = decompress_init(comp.desc.color_spec, [Codec.UYVY], device="cpu")
    ref_dec, ref_out = ref_decompress_init(RefCodec(int(comp.desc.color_spec)), [RefCodec.UYVY])
    assert int(out) == int(ref_out) == int(Codec.UYVY)
    got = dec.decompress(comp, out)
    want = ref_dec.decompress(ref, ref_out)
    assert isinstance(got.data, torch.Tensor) and got.data.dtype == torch.uint8 and got.data.device.type == "cpu"
    assert got.desc.color_spec == Codec.UYVY and got.timestamp == 1.5
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    if spec.endswith(":100") and codec == Codec.UYVY:
        assert np.array_equal(got.data.numpy(), data[:, : 2 * w])


def test_modules_return_none_for_an_input_without_conversion():
    desc = VideoDesc(64, 32, Codec.DXT1, 30.0)
    for spec in ("jpegxs", "cineform"):
        assert compress_init(spec, device="cpu").compress(VideoFrame(desc, [torch.zeros(1024, dtype=torch.uint8)])) \
            is None
    dec, _ = decompress_init(Codec.JPEG_XS, [Codec.UYVY], device="cpu")
    assert dec.decompress(VideoFrame(desc.with_(color_spec=Codec.JPEG_XS), [np.zeros(8, np.uint8)]), Codec.RGB) is None
