"""The port's APV codec (``ops/apv.py``) and its modules against the JAX
package on the CPU.

The transform is float32: a level is ``round(c * inv_step)``, so a
coefficient on an exact .5 moves with the summation order.  The port sums
each 8-term product in the order XLA's CPU dot of K = 8 uses (four partial
fused multiply-add chains, then (p0 + p1) + (p2 + p3); see
``ultragrid_tpu_torch/ops/apv.py``), so levels, reconstructions, streams
and decoded planes are equal to the reference's with no tolerance, down to
planes of one 8x8 block.  Inputs are made from a seed with numpy.
"""

import hashlib
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules.video_compress import compress_init as ref_compress_init  # noqa: E402
from ultragrid_tpu.modules.video_decompress import decompress_init as ref_decompress_init  # noqa: E402
from ultragrid_tpu.ops import apv as ref_apv  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch.modules.video_compress import ApvCompress, compress_init  # noqa: E402
from ultragrid_tpu_torch.modules.video_decompress import ApvDecompress, decompress_init  # noqa: E402
from ultragrid_tpu_torch.ops import apv  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

from tests.torch_h264_helpers import picture  # noqa: E402

# the reference test's golden digest (tests/test_apv.py:138)
APV_GOLDEN = "9e62674295f42d8f4b784b1af9331b7301be2e40fca22141e3db08bb1391f8c0"


def _rand(shape, seed, lo=0, hi=1024):
    return np.random.default_rng(seed).integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


def _host(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


# ---------------------------------------------------------------------------
# the device stage: the transform and quantiser, forward and inverse
# ---------------------------------------------------------------------------

# planes from one 8x8 block (8 rows in XLA's dot) to 64 blocks, and the qp
# range (a step of 0.625 at qp 0 to 0.625 * 2^10.5 at qp 63)
SHAPES = [(8, 8), (8, 16), (16, 16), (8, 56), (16, 32), (24, 40), (64, 64)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
@pytest.mark.parametrize("qp", [0, 7, 18, 36, 63])
def test_levels_and_reconstruction_equal_reference(shape, qp):
    plane = _rand(shape, qp * 100 + sum(shape))
    step = apv.qp_to_step(qp)
    want = np.asarray(ref_apv._fwd_fn(*shape, 512)(plane, np.float32(1.0 / step)))
    got = apv.forward_levels(torch.as_tensor(plane), 512, 1.0 / step)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    rec = apv.inverse_levels(torch.as_tensor(want.copy()), 512, 1023, step)
    assert np.array_equal(rec.numpy(), np.asarray(ref_apv._inv_fn(*shape, 512, 1023)(want, np.float32(step))))


def test_levels_equal_reference_at_8_bit():
    """bit_depth 8: center 128, clip at 255."""
    plane = _rand((32, 48), 11, 0, 256)
    step = apv.qp_to_step(12)
    want = np.asarray(ref_apv._fwd_fn(32, 48, 128)(plane, np.float32(1.0 / step)))
    assert np.array_equal(apv.forward_levels(torch.as_tensor(plane), 128, 1.0 / step).numpy(), want)
    assert np.array_equal(apv.inverse_levels(torch.as_tensor(want.copy()), 128, 255, step).numpy(),
                          np.asarray(ref_apv._inv_fn(32, 48, 128, 255)(want, np.float32(step))))


def test_blocks_round_trip_as_the_reference():
    plane = torch.as_tensor(_rand((16, 24), 3))
    blocks = apv._blockify(plane)
    assert np.array_equal(blocks.numpy(), np.asarray(ref_apv._blockify(plane.numpy())))
    assert torch.equal(apv._unblockify(blocks, 16, 24), plane)


# ---------------------------------------------------------------------------
# the Rice layer (host, copied)
# ---------------------------------------------------------------------------


def test_rice_layer_equals_reference():
    rng = np.random.default_rng(0)
    for trial in range(6):
        k = int(rng.integers(0, 12))
        vals = rng.integers(0, 40 << k if k else 40, int(rng.integers(1, 3000)), dtype=np.int64)
        assert apv._rice_k(vals) == ref_apv._rice_k(vals)
        bw, rbw = apv._BitWriter(), ref_apv._BitWriter()
        apv._rice_put(bw, vals, k)
        ref_apv._rice_put(rbw, vals, k)
        assert bw.tobytes() == rbw.tobytes()
        assert np.array_equal(apv._rice_decode_vec(apv._BitReader(bw.tobytes()), vals.size, k), vals)
    assert apv._rice_k(np.array([0, 1, 2, 1 << 16], np.int64)) == ref_apv._rice_k(np.array([0, 1, 2, 1 << 16]))
    assert apv._even_split(37, 4) == ref_apv._even_split(37, 4)


# ---------------------------------------------------------------------------
# streams and decoded planes
# ---------------------------------------------------------------------------


def _ramp(h, w, mul):
    return ((np.indices((h, w)).sum(0) * mul) % 1024).astype(np.int32)


# the cases of tests/test_apv.py: near-lossless 4:2:2, lossy 4:0:0, odd
# 4:0:0, 4:4:4, the tile grid, and more (chroma qp offset, 8 bits)
Y_GRID = _ramp(160, 640, 3)
STREAM_CASES = {
    "422-qp0": ([_ramp(120, 200, 7), _rand((120, 100), 1, 300, 700), _rand((120, 100), 2, 300, 700)], {"qp": 0}),
    "400-qp24": ([_ramp(128, 256, 3)], {"qp": 24}),
    "400-odd-qp0": ([_rand((37, 53), 5)], {"qp": 0}),
    "444-qp12": ([_rand((64, 80), 7 + i) for i in range(3)], {"qp": 12}),
    "422-tiled": ([Y_GRID, (Y_GRID[:, ::2] // 2 + 100).astype(np.int32), (Y_GRID[:, 1::2] // 3 + 200).astype(np.int32)],
                  {"qp": 20, "tile_w": 256, "tile_h": 96}),
    "422-one-tile": ([Y_GRID, (Y_GRID[:, ::2] // 2 + 100).astype(np.int32),
                      (Y_GRID[:, 1::2] // 3 + 200).astype(np.int32)], {"qp": 20, "tile_w": 1 << 20, "tile_h": 1 << 20}),
    "422-cqo": ([_rand((48, 64), 3), _rand((48, 32), 4), _rand((48, 32), 5)], {"qp": 30, "chroma_qp_offset": -4}),
    "422-odd-qp51": ([_rand((38, 70), 6), _rand((38, 35), 7), _rand((38, 35), 8)], {"qp": 51}),
    "8-bit": ([_rand((40, 56), 9, 0, 256)], {"qp": 10, "bit_depth": 8}),
}


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_stream_and_planes_equal_reference(case):
    planes, kw = STREAM_CASES[case]
    stream = apv.ApvCodec(device="cpu", **kw).encode_planes(planes)
    assert stream == ref_apv.ApvCodec(**kw).encode_planes(planes)
    got = apv.ApvCodec(device="cpu").decode_planes(stream)
    want = ref_apv.ApvCodec().decode_planes(stream)
    assert len(got) == len(want) == len(planes)
    for g, w, p in zip(got, want, planes):
        assert g.dtype == torch.int32 and g.shape == p.shape and np.array_equal(g.numpy(), w)


def test_tile_grid_only_partitions_the_entropy_layer():
    tiled = apv.ApvCodec(device="cpu", **STREAM_CASES["422-tiled"][1]).encode_planes(STREAM_CASES["422-tiled"][0])
    single = apv.ApvCodec(device="cpu", **STREAM_CASES["422-one-tile"][1]).encode_planes(
        STREAM_CASES["422-one-tile"][0])
    assert tiled[16:18] != single[16:18]
    for a, b in zip(apv.ApvCodec(device="cpu").decode_planes(tiled), apv.ApvCodec(device="cpu").decode_planes(single)):
        assert torch.equal(a, b)


def test_golden_digest():
    plane = (np.arange(48 * 64, dtype=np.int64).reshape(48, 64) * 13 % 1021).astype(np.int32)
    stream = apv.ApvCodec(qp=18, device="cpu").encode_planes([plane])
    assert hashlib.sha256(stream).hexdigest() == APV_GOLDEN
    assert np.abs(apv.ApvCodec(device="cpu").decode_planes(stream)[0].numpy() - plane).max() <= 16


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

SPECS = ["openapv", "openapv:qp=0", "apv:36", "openapv:qp=24:tile_w=64:tile_h=32"]
FRAMES = [(128, 64, "bars", Codec.UYVY), (70, 38, "picture", Codec.UYVY), (64, 32, "noise", Codec.RGB)]


def _frame(w, h, kind, codec):
    if kind == "bars":
        return np.asarray(generate_pattern(w, h, codec, "bars", device="cpu"))
    if kind == "picture":
        return picture(w, h, w + h)
    return np.random.default_rng(w).integers(0, 256, (h, 3 * w), dtype=np.uint8)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("w,h,kind,codec", FRAMES, ids=[f"{w}x{h}-{k}-{c.name}" for w, h, k, c in FRAMES])
def test_modules_equal_reference(spec, w, h, kind, codec):
    data = _frame(w, h, kind, codec)
    comp = compress_init(spec, device="cpu").compress(VideoFrame(VideoDesc(w, h, codec, 30.0), [torch.as_tensor(data)],
                                                                 2.0))
    ref = ref_compress_init(spec).compress(RefFrame(RefDesc(w, h, RefCodec(int(codec)), 30.0), [data]))
    assert comp.desc.color_spec == Codec.APV and comp.timestamp == 2.0
    assert bytes(_host(comp.data)) == bytes(np.asarray(ref.data))
    dec, out = decompress_init(Codec.APV, [Codec.RGB, Codec.UYVY], device="cpu")
    ref_dec, ref_out = ref_decompress_init(RefCodec.APV, [RefCodec.UYVY])
    assert isinstance(dec, ApvDecompress) and out == Codec.UYVY
    got, want = dec.decompress(comp, out), ref_dec.decompress(ref, ref_out)
    assert got.data.dtype == torch.uint8 and got.data.device.type == "cpu" and got.timestamp == 2.0
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))


def test_module_parses_the_reference_config():
    for spec, qp, tw, th in (("", 18, 1920, 1080), ("7", 7, 1920, 1080), ("qp=9:tile_w=256:tile_h=128", 9, 256, 128)):
        c = ApvCompress(spec, device="cpu").codec
        assert (c.qp, c.tile_w, c.tile_h, c.bit_depth) == (qp, tw, th, 10)


def test_decompress_decimates_444_and_refuses_400_as_the_reference(capsys):
    planes = [_rand((32, 48), 20 + i) for i in range(3)]
    desc = VideoDesc(48, 32, Codec.APV, 30.0)
    s444 = apv.ApvCodec(qp=6, device="cpu").encode_planes(planes)
    got = ApvDecompress(device="cpu").decompress(VideoFrame(desc, [np.frombuffer(s444, np.uint8)]), Codec.UYVY)
    want = ref_decompress_init(RefCodec.APV, [RefCodec.UYVY])[0].decompress(
        RefFrame(RefDesc(48, 32, RefCodec.APV, 30.0), [np.frombuffer(s444, np.uint8)]), RefCodec.UYVY)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
    s400 = apv.ApvCodec(device="cpu").encode_planes(planes[:1])
    capsys.readouterr()
    assert ApvDecompress(device="cpu").decompress(VideoFrame(desc, [np.frombuffer(s400, np.uint8)]), Codec.UYVY) is None
    assert "only 4:2:2/4:4:4 streams map to UYVY" in capsys.readouterr().err
    assert struct.unpack_from("<B", s400, 5)[0] == 0  # profile 4:0:0
