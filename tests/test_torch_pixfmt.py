"""The port's pixel-format layer against the JAX reference's.

Same frames (numpy, from a seed) through ``ultragrid_tpu.ops.pixfmt`` on the
JAX CPU and through ``ultragrid_tpu_torch.ops.pixfmt`` on the CPU: every
registered conversion pair, the conversion ranking and its policy, the
planar converters, the nearest-neighbour scale and the colour coefficients.
Tolerance: byte equality everywhere (integer math on both sides).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ultragrid_tpu.ops import color as ref_color  # noqa: E402
from ultragrid_tpu.ops import pixfmt as ref_pixfmt  # noqa: E402
from ultragrid_tpu.ops import planar as ref_planar  # noqa: E402
from ultragrid_tpu.ops import postprocess as ref_post  # noqa: E402
from ultragrid_tpu.types import Codec, vc_get_linesize  # noqa: E402
from ultragrid_tpu_torch.ops import color as port_color  # noqa: E402
from ultragrid_tpu_torch.ops import pixfmt as port_pixfmt  # noqa: E402
from ultragrid_tpu_torch.ops import planar as port_planar  # noqa: E402
from ultragrid_tpu_torch.ops import postprocess as port_post  # noqa: E402
from ultragrid_tpu_torch.types import Codec as PCodec  # noqa: E402

WIDTH, HEIGHT = 192, 8  # as tests/test_pixfmt.py: a multiple of every block


def rand_frame(codec, width, height, rng):
    ls = vc_get_linesize(width, codec)
    return rng.integers(0, 256, size=(height, ls), dtype=np.uint16).astype(np.uint8)


def port(codec):
    return PCodec(int(codec))


@pytest.mark.parametrize("pair", ref_pixfmt.conversion_pairs(), ids=lambda p: f"{p[0].name}->{p[1].name}")
def test_conversion_matches_reference(pair):
    in_codec, out_codec = pair
    rng = np.random.default_rng(42 + int(in_codec) * 100 + int(out_codec))
    src = rand_frame(in_codec, WIDTH, HEIGHT, rng)
    want = np.asarray(ref_pixfmt.convert_frame(src, WIDTH, in_codec, out_codec))
    got = port_pixfmt.convert_frame(src, WIDTH, port(in_codec), port(out_codec), device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)


def test_conversion_pairs_equal_reference():
    ref = [(int(a), int(b)) for a, b in ref_pixfmt.conversion_pairs()]
    got = [(int(a), int(b)) for a, b in port_pixfmt.conversion_pairs()]
    assert got == ref and len(got) == 61


CANDIDATE_SETS = [
    [Codec.RGB, Codec.Y216, Codec.UYVY],
    [Codec.RGB, Codec.UYVY],
    [Codec.RGBA, Codec.RG48, Codec.R10k, Codec.Y416],
    [Codec.v210, Codec.RGB, Codec.R12L],
    [Codec.UYVY, Codec.YUYV, Codec.VUYA, Codec.RGBA],
    [Codec.I420, Codec.DXT1],
]


@pytest.mark.parametrize("policy", ["".join(p) for p in itertools.permutations("dsc")])
def test_best_decoder_matches_reference(policy):
    try:
        ref_pixfmt.set_pixfmt_conv_policy(policy)
        port_pixfmt.set_pixfmt_conv_policy(policy)
        for in_codec in Codec:
            for cands in CANDIDATE_SETS:
                _, want = ref_pixfmt.get_best_decoder_from(in_codec, cands)
                fn, got = port_pixfmt.get_best_decoder_from(port(in_codec), [port(c) for c in cands])
                assert (None if got is None else int(got)) == (None if want is None else int(want)), \
                    (policy, in_codec.name, [c.name for c in cands])
                assert (fn is None) == (want is None)
                src, dst = port_pixfmt.get_pixfmt_desc(port(in_codec)), ref_pixfmt.get_pixfmt_desc(in_codec)
                for a, b in itertools.combinations(cands, 2):
                    assert port_pixfmt.compare_pixdesc(port_pixfmt.get_pixfmt_desc(port(a)),
                                                       port_pixfmt.get_pixfmt_desc(port(b)), src) == \
                        ref_pixfmt.compare_pixdesc(ref_pixfmt.get_pixfmt_desc(a), ref_pixfmt.get_pixfmt_desc(b), dst)
    finally:
        ref_pixfmt.set_pixfmt_conv_policy("dsc")
        port_pixfmt.set_pixfmt_conv_policy("dsc")


@pytest.mark.parametrize("policy", ["ds", "dss", "abc", ""])
def test_bad_policy_raises_as_reference(policy):
    with pytest.raises(ValueError):
        ref_pixfmt.set_pixfmt_conv_policy(policy)
    with pytest.raises(ValueError):
        port_pixfmt.set_pixfmt_conv_policy(policy)
    assert port_pixfmt.PIXFMT_CONV_PREF == "dsc"


def _planar_cases():
    rng = np.random.default_rng(7)
    w, h = 48, 8
    uyvy = rand_frame(Codec.UYVY, w, h, rng)
    v210 = rand_frame(Codec.v210, w, h, rng)
    y416 = rand_frame(Codec.Y416, w, h, rng)
    i420 = rng.integers(0, 256, w * h * 3 // 2, dtype=np.uint16).astype(np.uint8)
    i422 = rng.integers(0, 256, w * h * 2, dtype=np.uint16).astype(np.uint8)
    i444 = rng.integers(0, 256, w * h * 3, dtype=np.uint16).astype(np.uint8)
    p16 = rng.integers(0, 1024, w * h * 3, dtype=np.uint16).view(np.uint8)
    p16_422 = rng.integers(0, 1024, w * h * 2, dtype=np.uint16).view(np.uint8)
    p16_420 = rng.integers(0, 1024, w * h * 3 // 2, dtype=np.uint16).view(np.uint8)
    y10 = rng.integers(0, 1024, (h, w), dtype=np.uint16)
    c10 = rng.integers(0, 1024, (h, w // 2), dtype=np.uint16)
    c10b = rng.integers(0, 1024, (h, w // 2), dtype=np.uint16)
    return [
        ("uyvy_to_i420", (uyvy, w, h)), ("i420_8_to_uyvy", (i420, w, h)),
        ("uyvy_to_i422", (uyvy, w, h)), ("i422_8_to_uyvy", (i422, w, h)),
        ("i444_8_to_uyvy", (i444, w, h)), ("uyvy_to_nv12", (uyvy, w, h)),
        ("y416_to_i444", (y416, w, h, 10)), ("y416_to_i444", (y416, w, h, 12)),
        ("i444_16_to_y416", (p16, w, h, 10)), ("i422_16_to_y416", (p16_422, w, h, 10)),
        ("i420_16_to_y416", (p16_420, w, h, 12)), ("v210_to_p010le", (v210, w, h)),
        ("yuv422p10le_to_v210", (y10, c10, c10b, w, h)),
    ]


@pytest.mark.parametrize("name,args", _planar_cases(), ids=lambda x: x if isinstance(x, str) else "")
def test_planar_matches_reference(name, args):
    want = getattr(ref_planar, name)(*args)
    targs = [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    got = getattr(port_planar, name)(*targs)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w_, g in zip(want, got):
        w_ = np.asarray(w_)
        assert g.numpy().dtype == w_.dtype and tuple(g.shape) == w_.shape, name
        np.testing.assert_array_equal(g.numpy(), w_)


@pytest.mark.parametrize("codec,width,height,new_w,new_h", [
    (Codec.UYVY, 64, 16, 32, 8), (Codec.UYVY, 64, 16, 128, 40), (Codec.UYVY, 1920, 8, 1280, 6),
    (Codec.RGB, 48, 12, 20, 7), (Codec.RGB, 48, 12, 100, 30), (Codec.RGBA, 30, 10, 45, 15),
])
def test_scale_nearest_matches_reference(codec, width, height, new_w, new_h):
    src = rand_frame(codec, width, height, np.random.default_rng(width + new_w))
    want = np.asarray(ref_post.scale_nearest(src, width, codec, new_w, new_h))
    got = port_post.scale_nearest(torch.as_tensor(src), width, port(codec), new_w, new_h)
    np.testing.assert_array_equal(got.numpy(), want)


def test_color_module_matches_reference():
    names = ["COMP_BASE", "KR_601", "KB_601", "KR_709", "KB_709", "KR_2020", "KB_2020", "KR_P3", "KB_P3"]
    for n in names:
        assert getattr(port_color, n) == getattr(ref_color, n), n
    for cs in (0, 1, 2):
        for depth in (0, 8, 10, 12, 16):
            a = port_color.get_color_coeffs(port_color.Colorspace(cs), depth)
            b = ref_color.get_color_coeffs(ref_color.Colorspace(cs), depth)
            assert vars(a) == vars(b), (cs, depth)
    for kr, kb in ((ref_color.KR_2020, ref_color.KB_2020), (ref_color.KR_P3, ref_color.KB_P3)):
        for depth in (0, 8, 10, 12, 16):
            assert vars(port_color.compute_color_coeffs(kr, kb, depth)) == \
                vars(ref_color.compute_color_coeffs(kr, kb, depth))
    for fn in ("limit_lo", "limit_hi_y", "limit_hi_cbcr", "full_foot", "full_head"):
        for depth in (8, 10, 12, 16):
            assert getattr(port_color, fn)(depth) == getattr(ref_color, fn)(depth), fn
    assert int(port_color.get_default_cs()) == int(ref_color.get_default_cs())


def test_convert_frame_device_contract():
    src = rand_frame(Codec.UYVY, WIDTH, HEIGHT, np.random.default_rng(3))
    t = torch.as_tensor(src)
    got = port_pixfmt.convert_frame(t, WIDTH, PCodec.UYVY, PCodec.RGB)  # a tensor stays on its device
    assert got.device.type == "cpu"
    assert torch.equal(got, port_pixfmt.convert_frame(src, WIDTH, PCodec.UYVY, PCodec.RGB, device="cpu"))
    # a short line is zero-padded, as the reference does
    want = np.asarray(ref_pixfmt.convert_frame(src[:, :-4], WIDTH, Codec.UYVY, Codec.RGB))
    np.testing.assert_array_equal(
        port_pixfmt.convert_frame(t[:, :-4], WIDTH, PCodec.UYVY, PCodec.RGB).numpy(), want)
    with pytest.raises(ValueError, match="no conversion"):
        port_pixfmt.convert_frame(t, WIDTH, PCodec.UYVY, PCodec.I420)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            port_pixfmt.convert_frame(src, WIDTH, PCodec.UYVY, PCodec.RGB)
