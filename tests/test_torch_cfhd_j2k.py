"""The port's host codecs against the JAX package: the real CineForm HD
bitstream (``ops/cfhd_bitstream.py``, ``ops/cfhd_tables.py``) and the own
JPEG 2000 codec (``ops/j2k.py`` with ``native/j2k_t1.c`` through the port's
loader), and the modules' refusals.

Both are numpy (and C) on the host in the reference and stay so in the
port: streams and decoded planes are equal byte for byte.  Neither libavcodec
nor Pillow (OpenJPEG) is an oracle here: the reference's decoders fall back
to them, the port's refuse by name.  Inputs are made from a seed with numpy.
"""

import hashlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules.video_compress import compress_init as ref_compress_init  # noqa: E402
from ultragrid_tpu.modules.video_decompress import J2kDecompress as RefJ2kDecompress  # noqa: E402
from ultragrid_tpu.ops import cfhd_bitstream as ref_cfhd  # noqa: E402
from ultragrid_tpu.ops import cfhd_tables as ref_tables  # noqa: E402
from ultragrid_tpu.ops import j2k as ref_j2k  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import native  # noqa: E402
from ultragrid_tpu_torch.modules.video_compress import CineformCompress, compress_init  # noqa: E402
from ultragrid_tpu_torch.modules.video_decompress import (CineformDecompress, J2kDecompress,  # noqa: E402
                                                          decompress_init)
from ultragrid_tpu_torch.ops import cfhd_bitstream, cfhd_tables, j2k  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

from tests.torch_h264_helpers import picture  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the reference test's golden digest (tests/test_j2k.py:132)
J2K_GOLDEN = "9be527f808147fff25561db1aec492f000c36eb5f84c19af10f63c538b165350"


def _host(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


# ---------------------------------------------------------------------------
# CineForm HD
# ---------------------------------------------------------------------------


def test_cfhd_tables_equal_reference():
    for name in ("BITS", "LENS", "LEVELS", "RUNS"):
        got, want = getattr(cfhd_tables, name), getattr(ref_tables, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


def _uyvy(w, h, kind, seed):
    if kind == "flat":
        return np.full((h, 2 * w), 128, np.uint8)
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, 2 * w), dtype=np.uint8)
    return picture(w, h, seed)


CFHD_CASES = [(64, 32, "picture", 90), (64, 32, "picture", 50), (96, 48, "noise", 80), (160, 40, "flat", 90),
              (64, 32, "picture", 99)]


@pytest.mark.parametrize("w,h,kind,quality", CFHD_CASES)
def test_cfhd_stream_and_planes_equal_reference(w, h, kind, quality):
    frame = _uyvy(w, h, kind, w + quality)
    stream = cfhd_bitstream.CfhdEncoder(w, h, quality=quality).encode_uyvy(frame)
    assert stream == ref_cfhd.CfhdEncoder(w, h, quality=quality).encode_uyvy(frame)
    got, want = cfhd_bitstream.cfhd_decode(stream, w, h), ref_cfhd.cfhd_decode(stream, w, h)
    assert len(got) == len(want) == 3
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and np.array_equal(g, r)


def test_cfhd_geometry_validation():
    with pytest.raises(ValueError):
        cfhd_bitstream.CfhdEncoder(130, 64)
    with pytest.raises(ValueError):
        cfhd_bitstream.CfhdEncoder(128, 62)


def test_cfhd_small_heights_fail_as_in_the_reference():
    """A reference limit, copied: the encoder takes width % 16 == 0 and
    height % 8 == 0, but raises at heights 8 and 16, and the own decoder
    cannot read its stream at height 24 (a lowpass of 3 rows)."""
    for w, h in ((64, 16), (32, 8)):
        for enc in (cfhd_bitstream.CfhdEncoder(w, h), ref_cfhd.CfhdEncoder(w, h)):
            with pytest.raises(IndexError):
                enc.encode_uyvy(_uyvy(w, h, "flat", 0))
    stream = cfhd_bitstream.CfhdEncoder(48, 24).encode_uyvy(_uyvy(48, 24, "picture", 1))
    assert stream == ref_cfhd.CfhdEncoder(48, 24).encode_uyvy(_uyvy(48, 24, "picture", 1))
    for dec in (cfhd_bitstream.cfhd_decode, ref_cfhd.cfhd_decode):
        with pytest.raises(ValueError):
            dec(stream, 48, 24)
    assert CineformDecompress(device="cpu").decompress(_cfhd_frame(stream, 48, 24), Codec.UYVY) is None


def test_cineform_decompress_of_cfhd_equals_reference():
    frame = _uyvy(64, 32, "picture", 7)
    comp = CineformCompress("85", device="cpu").compress(VideoFrame(VideoDesc(64, 32, Codec.UYVY, 30.0),
                                                                    [torch.as_tensor(frame)]))
    assert bytes(_host(comp.data)[:2]) != b"UC"  # real CFHD, not UCF1
    got = CineformDecompress(device="cpu").decompress(comp, Codec.UYVY)
    ref = ref_compress_init("cineform:85").compress(RefFrame(RefDesc(64, 32, RefCodec.UYVY, 30.0), [frame]))
    assert bytes(np.asarray(ref.data)) == bytes(_host(comp.data))
    from ultragrid_tpu.modules.video_decompress import CineformDecompress as RefCineformDecompress

    want = RefCineformDecompress().decompress(ref, RefCodec.UYVY)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))


def _cfhd_frame(stream, w=64, h=32):
    return VideoFrame(VideoDesc(w, h, Codec.CFHD, 30.0), [np.frombuffer(stream, np.uint8)])


@pytest.mark.parametrize("what", ["truncated-half", "truncated-3/4", "random", "zeros"])
def test_foreign_cfhd_stream_gives_none_and_names_libavcodec(what, capsys):
    stream = cfhd_bitstream.CfhdEncoder(64, 32).encode_uyvy(_uyvy(64, 32, "picture", 3))
    foreign = {"truncated-half": stream[: len(stream) // 2], "truncated-3/4": stream[: 3 * len(stream) // 4],
               "random": np.random.default_rng(0).integers(0, 256, 4000, dtype=np.uint8).tobytes(),
               "zeros": bytes(100)}[what]
    capsys.readouterr()
    # the own decoder cannot parse it: libavcodec's cfhd decoder takes it
    # where it is present (None, as the reference's gives), else an error
    assert CineformDecompress(device="cpu").decompress(_cfhd_frame(foreign), Codec.UYVY) is None
    err = capsys.readouterr().err
    assert "cineform" in err and "libavcodec" in err
    if native.lavc_headers_present():
        from ultragrid_tpu.modules.video_decompress import CineformDecompress as RefCineformDecompress

        ref = RefFrame(RefDesc(64, 32, RefCodec.CFHD, 30.0), [np.frombuffer(foreign, np.uint8)])
        assert RefCineformDecompress().decompress(ref, RefCodec.UYVY) is None


# ---------------------------------------------------------------------------
# JPEG 2000
# ---------------------------------------------------------------------------


def test_j2k_t1_loader_builds_the_shared_source():
    lib = native.j2k_t1_lib()
    assert lib.j2k_t1_encode_cblk.restype is not None and native.j2k_t1_lib() is lib


@pytest.mark.parametrize("shape", [(32, 64), (37, 53), (1, 17), (16, 1)])
def test_j2k_dwt_equals_reference(shape):
    p = np.random.default_rng(sum(shape)).integers(-2048, 2048, shape).astype(np.int32)
    for levels in (1, 3):
        ll, det = j2k.dwt53_decompose(p, levels)
        rll, rdet = ref_j2k.dwt53_decompose(p, levels)
        assert np.array_equal(ll, rll) and all(np.array_equal(a, b) for d, rd in zip(det, rdet) for a, b in zip(d, rd))
        assert np.array_equal(j2k.dwt53_reconstruct(ll, det), p)


J2K_CASES = [("rgb", (64, 96, 3), 100, 5), ("rgb", (61, 83, 3), 100, 5), ("rgb", (16, 16, 3), 100, 5),
             ("smooth", (64, 96, 3), 70, 5), ("rgb", (48, 80, 3), 90, 3), ("gray", (37, 61), 100, 3),
             ("gray", (32, 48), 60, 2)]


@pytest.mark.parametrize("kind,shape,quality,levels", J2K_CASES)
def test_j2k_stream_and_planes_equal_reference(kind, shape, quality, levels):
    rng = np.random.default_rng(shape[0] * quality)
    if kind == "smooth":
        x = np.indices(shape[:2]).sum(axis=0)
        img = np.stack([(x * 2) % 256, (x * 3) % 256, x % 256], axis=-1).astype(np.uint8)
    else:
        img = rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "gray":
        cs, ref_cs = j2k.encode_gray(img, levels, quality), ref_j2k.encode_gray(img, levels, quality)
    else:
        cs, ref_cs = j2k.encode_rgb_lossless(img, levels, quality), ref_j2k.encode_rgb_lossless(img, levels, quality)
    assert cs == ref_cs
    got, want = j2k.J2KDecoder().decode(cs), ref_j2k.J2KDecoder().decode(cs)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    if quality == 100:
        assert np.array_equal(np.stack(got, axis=-1) if kind != "gray" else got[0], img)


def test_j2k_golden_digest():
    plane = (np.arange(32 * 48, dtype=np.int64).reshape(32, 48) % 251).astype(np.uint8)
    cs = j2k.encode_gray(plane, levels=3, quality=100)
    assert hashlib.sha256(cs).hexdigest() == J2K_GOLDEN
    assert np.array_equal(j2k.J2KDecoder().decode(cs)[0], plane)


J2K_MODULE_CASES = [("cmpto_j2k:100", 128, 64, "bars"), ("j2k:90", 128, 64, "bars"), ("j2k", 62, 37, "picture"),
                    ("cmpto_j2k:70", 62, 37, "picture")]


@pytest.mark.parametrize("spec,w,h,kind", J2K_MODULE_CASES)
def test_j2k_modules_equal_reference(spec, w, h, kind):
    data = np.asarray(generate_pattern(w, h, Codec.UYVY, "bars", device="cpu")) if kind == "bars" else \
        picture(w, h, 5)
    comp = compress_init(spec, device="cpu").compress(VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0),
                                                                 [torch.as_tensor(data)], 3.0))
    ref = ref_compress_init(spec).compress(RefFrame(RefDesc(w, h, RefCodec.UYVY, 30.0), [data]))
    assert comp.desc.color_spec == Codec.J2KR and comp.timestamp == 3.0
    assert bytes(_host(comp.data)) == bytes(np.asarray(ref.data))
    dec, out = decompress_init(Codec.J2KR, [Codec.UYVY, Codec.RGB], device="cpu")
    assert isinstance(dec, J2kDecompress) and out == Codec.RGB
    got = dec.decompress(comp, out)
    want = RefJ2kDecompress().decompress(ref, RefCodec.RGB)
    assert got.data.dtype == torch.uint8 and got.data.device.type == "cpu" and got.desc.color_spec == Codec.RGB
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))


def _j2k_frame(cs):
    return VideoFrame(VideoDesc(48, 32, Codec.J2KR, 30.0), [np.frombuffer(cs, np.uint8)])


@pytest.mark.parametrize("what", ["two-layers", "no-soc", "truncated", "truncated-header"])
def test_j2k_outside_the_profile_or_corrupt_gives_none_and_names_openjpeg(what, capsys):
    cs = j2k.encode_rgb_lossless(np.random.default_rng(1).integers(0, 256, (32, 48, 3)).astype(np.uint8), levels=3)
    bad = bytearray(cs)
    bad[cs.index(b"\xff\x52") + 7] = 2  # COD: two quality layers, outside the own profile
    stream = {"two-layers": bytes(bad), "no-soc": cs[2:], "truncated": cs[: len(cs) // 2],
              "truncated-header": cs[:30]}[what]
    capsys.readouterr()
    assert J2kDecompress(device="cpu").decompress(_j2k_frame(stream), Codec.RGB) is None
    err = capsys.readouterr().err
    assert "j2k" in err and "OpenJPEG" in err and "not ported" in err


REFUSALS = r"""
import sys
for name in ("PIL", "jax", "ultragrid_tpu"):
    sys.modules[name] = None
import numpy as np
from ultragrid_tpu_torch.modules.video_decompress import CineformDecompress, J2kDecompress
from ultragrid_tpu_torch.ops.j2k import encode_rgb_lossless
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
cs = encode_rgb_lossless(np.zeros((16, 16, 3), np.uint8), levels=2)
for bad in (cs[2:], cs[: len(cs) // 2]):
    assert J2kDecompress(device="cpu").decompress(
        VideoFrame(VideoDesc(16, 16, Codec.J2KR, 30.0), [np.frombuffer(bad, np.uint8)]), Codec.RGB) is None
assert CineformDecompress(device="cpu").decompress(
    VideoFrame(VideoDesc(16, 16, Codec.CFHD, 30.0), [np.zeros(64, np.uint8)]), Codec.UYVY) is None
assert J2kDecompress(device="cpu").decompress(
    VideoFrame(VideoDesc(16, 16, Codec.J2KR, 30.0), [np.frombuffer(cs, np.uint8)]), Codec.RGB) is not None
print("REFUSED-OK")
"""


def test_refusals_import_neither_pil_nor_jax():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    res = subprocess.run([sys.executable, "-c", REFUSALS], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "REFUSED-OK" in res.stdout and "OpenJPEG" in res.stderr and "libavcodec" in res.stderr
