"""The port's DXT1 / DXT1_YUV / DXT5-YCoCg against the JAX reference's.

Same frames (numpy, from a seed) through ``ultragrid_tpu.ops.dxt`` on the
JAX CPU and ``ultragrid_tpu_torch.ops.dxt`` on the CPU, and the compress
and decompress modules built on them.

Tolerance.  The encoders are float32 over [nblocks, 16] lanes; the port
rounds every step as XLA compiles the reference for the CPU (reciprocal
constants, fused multiply-adds, the lane sums' order), so the rule is at
most 0.1% of the blocks differing (``MAX_BLOCK_SHARE``; at 64x32 that is
0 blocks), the decoded frames' PSNR to the source within 0.01 dB of the
reference's.  The decoders are held to byte equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ultragrid_tpu.modules import video_compress as ref_vc  # noqa: E402
from ultragrid_tpu.modules import video_decompress as ref_vd  # noqa: E402
from ultragrid_tpu.ops import dxt as ref_dxt  # noqa: E402
from ultragrid_tpu.ops import jpeg as ref_jpeg  # noqa: E402
from ultragrid_tpu.ops.jpeg import JpegEncoder as RefJpegEncoder  # noqa: E402
from ultragrid_tpu.ops.planar import uyvy_to_i420  # noqa: E402
from ultragrid_tpu.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch import types as pt  # noqa: E402
from ultragrid_tpu_torch.modules import video_compress as port_vc  # noqa: E402
from ultragrid_tpu_torch.modules import video_decompress as port_vd  # noqa: E402
from ultragrid_tpu_torch.ops import dxt as port_dxt  # noqa: E402

MAX_BLOCK_SHARE = 0.001
SIZES = [(64, 32), (256, 128)]
ENCODERS = [  # (name, input bytes per pixel, output bytes per block)
    ("dxt1_encode_rgb", 3, 8), ("dxt1_encode_uyvy", 2, 8), ("dxt1_yuv_encode_uyvy", 2, 8),
    ("dxt5_ycocg_encode_rgb", 3, 16), ("dxt5_ycocg_encode_uyvy", 2, 16),
]


def content(h, ls, seed):
    """Gradient plus sensor-like noise, limited range (as bench.py)."""
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, ls, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


def source(kind, h, ls, seed):
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, ls), dtype=np.uint8)
    return content(h, ls, seed)


def differing_blocks(a, b, bpb):
    a, b = np.asarray(a).reshape(-1, bpb), np.asarray(b).reshape(-1, bpb)
    assert a.shape == b.shape
    return int((a != b).any(axis=1).sum())


def psnr(a, b):
    mse = float(((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name,bpp,bpb", ENCODERS, ids=[e[0] for e in ENCODERS])
@pytest.mark.parametrize("w,h", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
@pytest.mark.parametrize("kind", ["content", "noise"])
def test_encoder_matches_reference(name, bpp, bpb, w, h, kind):
    src = source(kind, h, bpp * w, w + bpb)
    want = np.asarray(getattr(ref_dxt, name)(src, w))
    got = getattr(port_dxt, name)(torch.as_tensor(src), w)
    assert got.dtype == torch.uint8 and got.numel() == want.size == w * h // 16 * bpb
    nblocks = w * h // 16
    assert differing_blocks(got.numpy(), want, bpb) <= int(MAX_BLOCK_SHARE * nblocks)


@pytest.mark.parametrize("w,h", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
@pytest.mark.parametrize("variant", ["dxt1", "dxt5"])
def test_decoder_matches_reference_and_psnr(w, h, variant):
    rgb = content(h, 3 * w, 5)
    enc = {"dxt1": "dxt1_encode_rgb", "dxt5": "dxt5_ycocg_encode_rgb"}[variant]
    dec = {"dxt1": "dxt1_decode_rgb", "dxt5": "dxt5_ycocg_decode_rgb"}[variant]
    ref_bytes = np.array(getattr(ref_dxt, enc)(rgb, w))
    want = np.asarray(getattr(ref_dxt, dec)(ref_bytes, w, h))
    got = getattr(port_dxt, dec)(torch.as_tensor(ref_bytes), w, h)
    np.testing.assert_array_equal(got.numpy(), want)  # decoders: byte-equal
    # the port's own encode, decoded: PSNR to the source as the reference's
    own = getattr(port_dxt, dec)(getattr(port_dxt, enc)(torch.as_tensor(rgb), w), w, h)
    assert abs(psnr(own.numpy(), rgb) - psnr(want, rgb)) <= 0.01


@pytest.mark.parametrize("cfg,codec", [("dxt:DXT1", Codec.RGB), ("dxt:DXT1", Codec.UYVY), ("dxt:DXT5", Codec.RGB),
                                       ("dxt:DXT5", Codec.UYVY), ("dxt:DXT1", Codec.RGBA), ("dxt", Codec.v210)])
def test_dxt_compress_module_matches_reference(cfg, codec):
    w, h = 64, 32
    from ultragrid_tpu.types import vc_get_linesize
    src = content(h, vc_get_linesize(w, codec), 9)
    kind = cfg.partition(":")[2]
    ref = ref_vc.DxtCompress(kind).compress(VideoFrame(VideoDesc(w, h, codec, 30.0), [src]))
    got = port_vc.DxtCompress(kind, device="cpu").compress(
        pt.VideoFrame(pt.VideoDesc(w, h, pt.Codec(int(codec)), 30.0), [src]))
    assert int(got.desc.color_spec) == int(ref.desc.color_spec)
    bpb = 8 if ref.desc.color_spec == Codec.DXT1 else 16
    assert differing_blocks(got.data.numpy(), np.asarray(ref.data), bpb) == 0


def test_dxt_compress_module_rejects_as_reference():
    frame = pt.VideoFrame(pt.VideoDesc(62, 32, pt.Codec.RGB, 30.0), [np.zeros((32, 186), np.uint8)])
    assert port_vc.DxtCompress("DXT1", device="cpu").compress(frame) is None
    with pytest.raises(ValueError):
        port_vc.DxtCompress("DXT9", device="cpu")


@pytest.mark.parametrize("variant", ["dxt1", "dxt5"])
def test_dxt_decompress_module_matches_reference(variant):
    w, h = 64, 32
    rgb = content(h, 3 * w, 11)
    codec = Codec.DXT1 if variant == "dxt1" else Codec.DXT5
    enc = np.asarray((ref_dxt.dxt1_encode_rgb if variant == "dxt1" else ref_dxt.dxt5_ycocg_encode_rgb)(rgb, w))
    ref = ref_vd.DxtDecompress().decompress(VideoFrame(VideoDesc(w, h, codec, 30.0), [enc]), Codec.RGB)
    dec = port_vd.DxtDecompress(device="cpu")
    got = dec.decompress(pt.VideoFrame(pt.VideoDesc(w, h, pt.Codec(int(codec)), 30.0), [enc]), pt.Codec.RGB)
    assert got.desc.color_spec == pt.Codec.RGB and tuple(got.data.shape) == (h, 3 * w)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert dec.decompress(pt.VideoFrame(pt.VideoDesc(w, h, pt.Codec(int(codec)), 30.0), [enc]),
                          pt.Codec.UYVY) is None


@pytest.mark.parametrize("out", [Codec.DXT1, Codec.DXT5])
def test_jpeg_to_dxt_matches_reference(out, monkeypatch):
    """JPEG -> DXT on the device, as tests/test_compress.py drives it.  The
    reference's module-level JPEG decoder caches its planes product under
    table ids, not values (ROADMAP F3), so it gets a fresh one here: a
    stream of another quality decoded earlier in the process would change
    its decode."""
    monkeypatch.setattr(ref_jpeg, "_DEVICE_DECODER", None)
    w, h = 128, 64
    uyvy = content(h, 2 * w, 13)
    jpeg = RefJpegEncoder(w, h, quality=90).encode(uyvy)
    ref = ref_vd.JpegToDxtDecompress().decompress(VideoFrame(VideoDesc(w, h, Codec.JPEG, 30.0), [jpeg]), out)
    got = port_vd.JpegToDxtDecompress(device="cpu").decompress(
        pt.VideoFrame(pt.VideoDesc(w, h, pt.Codec.JPEG, 30.0), [jpeg]), pt.Codec(int(out)))
    assert int(got.desc.color_spec) == int(out)
    bpb = 8 if out == Codec.DXT1 else 16
    assert differing_blocks(got.data.numpy(), np.asarray(ref.data), bpb) <= int(MAX_BLOCK_SHARE * w * h / 16)


def test_i420_uyvy_none_modules_match_reference():
    w, h = 64, 32
    uyvy = content(h, 2 * w, 15)
    i420 = np.asarray(uyvy_to_i420(uyvy, w, h))
    ref = ref_vd.I420Decompress().decompress(VideoFrame(VideoDesc(w, h, Codec.I420, 30.0), [i420]), Codec.UYVY)
    got = port_vd.I420Decompress(device="cpu").decompress(
        pt.VideoFrame(pt.VideoDesc(w, h, pt.Codec.I420, 30.0), [i420]), pt.Codec.UYVY)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    rgb = content(h, 3 * w, 16)
    ref = ref_vc.UyvyCompress("").compress(VideoFrame(VideoDesc(w, h, Codec.RGB, 30.0), [rgb]))
    frame = pt.VideoFrame(pt.VideoDesc(w, h, pt.Codec.RGB, 30.0), [rgb])
    got = port_vc.UyvyCompress("", device="cpu").compress(frame)
    assert got.desc.color_spec == pt.Codec.UYVY
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    assert port_vc.NoneCompress("", device="cpu").compress(frame) is frame
    assert port_vc.UyvyCompress("", device="cpu").compress(
        pt.VideoFrame(pt.VideoDesc(w, h, pt.Codec.DXT1, 30.0), [rgb])) is None
