"""The port's ``ops/postprocess.py`` against the JAX package's, on the CPU.

Every function on every codec it takes, inputs from a seed.  Tolerance:
byte-equal everywhere (0 differing bytes), the float32 functions included:
the port writes out each rounding of the reference as XLA's CPU compile
gives it (see the module's docstring).  ``add_noise`` draws from a torch
generator, which ``jax.random`` cannot be reproduced by, so it is held to
its contract instead: every output byte within ``±amount`` of the input and
in 0..255, the same bytes for the same seed, other bytes for another seed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ultragrid_tpu.ops import postprocess as ref_pp  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu_torch.ops import postprocess as pp  # noqa: E402
from ultragrid_tpu_torch.types import Codec, vc_get_linesize  # noqa: E402

W, H = 192, 128
SIZES = [(192, 128), (64, 32), (48, 17)]
DEINT_CODECS = ["UYVY", "YUYV", "RGB", "RGBA", "v210", "Y216", "RG48", "R10k"]
RGB_CODECS = ["RGB", "RGBA"]


def frame(w, h, codec, seed):
    ls = vc_get_linesize(w, Codec[codec])
    return np.random.default_rng(seed).integers(0, 256, (h, ls), dtype=np.uint8)


def port(fn, src, *args):
    return fn(torch.as_tensor(src), *args).numpy()


def ref(fn, src, *args):
    return np.asarray(fn(jnp.asarray(src), *args))


def assert_equal(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("codec", DEINT_CODECS)
@pytest.mark.parametrize("w,h", SIZES[:2])
def test_deinterlace_blend_and_linear(codec, w, h):
    if codec == "v210" and w % 48:
        w = 96
    src = frame(w, h, codec, 1)
    for name in ("deinterlace_blend", "deinterlace_linear"):
        assert_equal(port(getattr(pp, name), src, Codec[codec]), ref(getattr(ref_pp, name), src, RefCodec[codec]))


def test_v210_avg_folds_padding_bits():
    """The top field is averaged unmasked: padding bits 30-31 take part."""
    src = np.full((4, vc_get_linesize(48, Codec.v210)), 0xFF, np.uint8)
    src[1::2] = 0xC0
    got = port(pp.deinterlace_blend, src, Codec.v210)
    assert_equal(got, ref(ref_pp.deinterlace_blend, src, RefCodec.v210))
    assert got[0, 3] != src[0, 3]


@pytest.mark.parametrize("h", [128, 127, 2, 1])
def test_fields(h):
    src = frame(W, h, "UYVY", 2)
    for name in ("deinterlace_bob_even", "deinterlace_bob_odd", "interlace", "flip"):
        if name == "deinterlace_bob_odd" and h == 1:
            continue  # no odd field
        assert_equal(port(getattr(pp, name), src), ref(getattr(ref_pp, name), src))
    if h > 1:
        got = pp.fields_to_frames(torch.as_tensor(src), Codec.UYVY)
        want = ref_pp.fields_to_frames(jnp.asarray(src), RefCodec.UYVY)
        for g, r in zip(got, want):
            assert_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("codec", ["UYVY", "YUYV", "RGB", "RGBA", "v210"])
def test_crop_mirror_blank(codec):
    w = 192
    src = frame(w, H, codec, 3)
    c, rc = Codec[codec], RefCodec[codec]
    for x, y, cw, ch in ((16, 8, 64, 32), (0, 0, w, H), (7, 5, 50, 1)):
        assert_equal(port(pp.crop, src, w, c, x, y, cw, ch), ref(ref_pp.crop, src, w, rc, x, y, cw, ch))
        for color in (0, 200):
            assert_equal(port(pp.blank_region, src, w, c, x, y, cw, ch, color),
                         ref(ref_pp.blank_region, src, w, rc, x, y, cw, ch, color))
    assert_equal(port(pp.mirror, src, w, c), ref(ref_pp.mirror, src, w, rc))


def test_blank_leaves_its_input():
    src = frame(W, H, "UYVY", 4)
    t = torch.as_tensor(src.copy())
    pp.blank_region(t, W, Codec.UYVY, 0, 0, W, H)
    assert np.array_equal(t.numpy(), src)


@pytest.mark.parametrize("gamma", [0.3, 0.45, 1 / 2.2, 0.5, 1.0, 1.8, 2.0, 2.2, 2.4, 3.0])
def test_gamma_every_byte(gamma):
    src = np.arange(256, dtype=np.uint8).reshape(2, 128)
    assert_equal(port(pp.gamma_correct, src, gamma), ref(ref_pp.gamma_correct, src, gamma))


def test_gamma_frame():
    src = frame(W, H, "RGB", 5)
    assert_equal(port(pp.gamma_correct, src, 2.2), ref(ref_pp.gamma_correct, src, 2.2))


@pytest.mark.parametrize("codec", ["UYVY", "YUYV", "RGB", "RGBA"])
@pytest.mark.parametrize("w,h", SIZES[:2])
def test_grayscale(codec, w, h):
    src = frame(w, h, codec, 6)
    assert_equal(port(pp.grayscale, src, w, Codec[codec]), ref(ref_pp.grayscale, src, w, RefCodec[codec]))


def test_grayscale_every_rgb_triple():
    """All 2^24 RGB triples: the fused products round as XLA's."""
    v = np.arange(256, dtype=np.uint8)
    src = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(4096, 4096 * 3)
    assert_equal(port(pp.grayscale, src, 4096, Codec.RGB), ref(ref_pp.grayscale, src, 4096, RefCodec.RGB))


def test_grayscale_rejects_other_codecs():
    with pytest.raises(ValueError):
        pp.grayscale(torch.zeros((4, 16), dtype=torch.uint8), 4, Codec.v210)


MATRICES = {
    "identity": np.eye(3),
    "bt601": np.array([[0.299, 0.587, 0.114], [0.5, -0.4187, -0.0813], [-0.1687, -0.3313, 0.5]]),
    "sepia": np.array([[0.393, 0.769, 0.189], [0.349, 0.686, 0.168], [0.272, 0.534, 0.131]]),
    "random": np.random.default_rng(7).normal(0.3, 0.5, (3, 3)),
}


@pytest.mark.parametrize("codec", RGB_CODECS)
@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("w,h", [(192, 128), (64, 32), (16, 8)])
def test_color_matrix(codec, name, w, h):
    src = frame(w, h, codec, 8)
    m = MATRICES[name]
    assert_equal(port(pp.color_matrix, src, w, Codec[codec], m), ref(ref_pp.color_matrix, src, w, RefCodec[codec], m))


@pytest.mark.parametrize("codec", RGB_CODECS)
@pytest.mark.parametrize("seed", [0, 1])
def test_logo_blit(codec, seed):
    rng = np.random.default_rng(10 + seed)
    src = frame(W, H, codec, 9 + seed)
    logo = rng.integers(0, 256, (24, 32, 4), dtype=np.uint8)
    logo[0, :, 3] = np.arange(32) * 8  # every alpha step
    for x, y in ((5, 7), (0, 0), (W - 32, H - 24)):
        assert_equal(port(pp.logo_blit, src, W, Codec[codec], logo, x, y),
                     ref(ref_pp.logo_blit, src, W, RefCodec[codec], logo, x, y))


MATRIX2 = {
    "y601_to_y709": np.array([1, -0.11555, -0.207938, 0, 1.01864, 0.114618, 0, 0.075049, 1.025327]),
    "identity": np.eye(3).reshape(9),
    "random_a": np.random.default_rng(11).normal(0.2, 0.6, 9),
    "random_b": np.random.default_rng(12).normal(0.0, 1.5, 9),
}


@pytest.mark.parametrize("name", sorted(MATRIX2))
def test_matrix2_uyvy(name):
    src = frame(W, H, "UYVY", 13)
    m = MATRIX2[name]
    assert_equal(port(pp.matrix2_uyvy, src, W, m), ref(ref_pp.matrix2_uyvy, src, W, m))


@pytest.mark.parametrize("codec", RGB_CODECS)
@pytest.mark.parametrize("new_w,new_h", [(40, 30), (256, 160)])
def test_scale_bilinear_rgb(codec, new_w, new_h):
    src = frame(W, H, codec, 14)
    assert_equal(port(pp.scale_bilinear_rgb, src, W, Codec[codec], new_w, new_h),
                 ref(ref_pp.scale_bilinear_rgb, src, W, RefCodec[codec], new_w, new_h))


@pytest.mark.parametrize("codec", ["UYVY", "RGB"])
@pytest.mark.parametrize("new_w,new_h", [(96, 64), (256, 160)])
def test_scale_nearest(codec, new_w, new_h):
    src = frame(W, H, codec, 15)
    assert_equal(port(pp.scale_nearest, src, W, Codec[codec], new_w, new_h),
                 ref(ref_pp.scale_nearest, src, W, RefCodec[codec], new_w, new_h))


@pytest.mark.parametrize("amount", [1, 16, 100])
def test_add_noise_contract(amount):
    src = frame(W, H, "UYVY", 16)
    src[:4] = 0
    src[4:8] = 255

    def noisy(seed):
        return pp.add_noise(torch.as_tensor(src), torch.Generator().manual_seed(seed), amount).numpy()

    a, b, c = noisy(3), noisy(3), noisy(4)
    d = a.astype(np.int32) - src
    assert a.dtype == np.uint8 and a.shape == src.shape
    assert np.abs(d).max() <= amount and d.min() < 0 < d.max()
    assert np.array_equal(a, np.clip(a, 0, 255))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # the global generator is not touched
    torch.manual_seed(0)
    before = torch.rand(4)
    torch.manual_seed(0)
    noisy(5)
    assert torch.equal(torch.rand(4), before)
