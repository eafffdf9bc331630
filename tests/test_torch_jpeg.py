"""The port's JPEG encode (plain PyTorch path) against the JAX reference.

Same frames, made with numpy from a seed, go through the reference's XLA
graph (``JpegEncoder._make_encode``) or its Pallas kernel in interpret mode,
and through ``ultragrid_tpu_torch``'s ``JpegEncoder.encode_plain`` on the
CPU.  Tolerance: exact equality of all seven outputs and of the assembled
file.  Every frame has at least 64 MCUs: below that, XLA's CPU dot sums in
another order than the fused multiply-add chain both use for larger frames,
and one case documents that bound.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from ultragrid_tpu.ops import jpeg as ref_jpeg  # noqa: E402
from ultragrid_tpu.ops import jpeg_pallas  # noqa: E402
from ultragrid_tpu.types import Codec, VideoDesc, VideoFrame, vc_get_linesize  # noqa: E402
from ultragrid_tpu_torch import types as port_types  # noqa: E402
from ultragrid_tpu_torch.device import DeviceFile  # noqa: E402
from ultragrid_tpu_torch.ops import jpeg as port_jpeg  # noqa: E402

NAMES = ("ys", "ybits", "us", "ubits", "vs", "vbits", "overflow")


def frame_for(w, h, codec, seed, kind="content"):
    ls = vc_get_linesize(w, codec)
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, ls), dtype=np.uint8)
    # gradient plus sensor-like noise, limited range (as bench.py)
    base = np.linspace(0, 255, ls, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


def assert_outputs_equal(ref_out, port_out):
    for name, a, b in zip(NAMES, ref_out, port_out):
        a = np.asarray(a)
        b = b.numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)  # int32 tensors carry the uint32 bits
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), f"{name} differs"


def pair(w, h, codec, q, ri=None, sub=None):
    return (ref_jpeg.JpegEncoder(w, h, in_codec=codec, quality=q, restart_interval=ri, subsampling=sub),
            port_jpeg.JpegEncoder(w, h, in_codec=port_types.Codec(codec), quality=q, restart_interval=ri,
                                  subsampling=sub))


CASES = [
    # (w, h, codec, quality, restart interval, subsampling, content)
    (256, 32, Codec.UYVY, 80, 2, None, "content"),
    (256, 32, Codec.UYVY, 95, None, None, "noise"),
    (128, 64, Codec.YUYV, 95, 1, None, "noise"),
    (256, 64, Codec.YUYV, 80, None, None, "content"),
    (128, 128, Codec.UYVY, 80, 2, "420", "noise"),
    (256, 64, Codec.YUYV, 95, 1, "420", "content"),
    (64, 64, Codec.RGB, 80, 4, None, "noise"),
    (128, 32, Codec.RGB, 95, None, None, "content"),
    (64, 64, Codec.RGBA, 80, 3, None, "noise"),
    # restart interval 3 does not divide the 5 MCUs of a row
    (80, 104, Codec.UYVY, 80, 3, None, "content"),
    (96, 176, Codec.UYVY, 80, 4, "420", "content"),
]


@pytest.mark.parametrize("w,h,codec,q,ri,sub,kind", CASES)
def test_plain_encode_matches_xla_graph(w, h, codec, q, ri, sub, kind):
    ref, enc = pair(w, h, codec, q, ri, sub)
    assert enc.wwords == ref.wwords
    frame = frame_for(w, h, codec, 7, kind)
    ref_out = jax.tree.map(np.asarray, ref._make_encode(ref.wwords)(frame))
    assert_outputs_equal(ref_out, enc.encode_plain(torch.as_tensor(frame)))


@pytest.mark.parametrize("w,h,codec,q,ri,sub", [
    (1024, 16, Codec.UYVY, 80, 2, None),
    (1024, 32, Codec.UYVY, 80, 2, "420"),
    (512, 16, Codec.RGB, 85, 4, None),
])
def test_plain_encode_matches_pallas_interpret(w, h, codec, q, ri, sub):
    """The TPU kernel K1 replaces, run in the Pallas interpreter (one grid
    step per MCU row: rows of 64 MCUs keep its dot in the chain order)."""
    ref, enc = pair(w, h, codec, q, ri, sub)
    frame = frame_for(w, h, codec, 3)
    fn = jpeg_pallas.make_fused_encode(ref, ref.wwords, interpret=True)
    assert fn is not None
    assert_outputs_equal(jax.tree.map(np.asarray, fn(frame)), enc.encode_plain(torch.as_tensor(frame)))


def test_overflow_flag_matches():
    ref, enc = pair(256, 32, Codec.UYVY, 95, 2)
    frame = frame_for(256, 32, Codec.UYVY, 5, "noise")
    enc.wwords = 2
    ref_out = jax.tree.map(np.asarray, ref._make_encode(2)(frame))
    port_out = enc.encode_plain(torch.as_tensor(frame))
    assert bool(ref_out[-1]) and bool(port_out[-1])
    assert_outputs_equal(ref_out, port_out)


def test_escalation_gives_the_reference_file():
    ref, enc = pair(256, 32, Codec.UYVY, 95, None)
    ref.wwords = enc.wwords = 2
    frame = frame_for(256, 32, Codec.UYVY, 9, "noise")
    want = ref.encode(frame)
    got = enc.encode(frame, device="cpu")
    assert enc.wwords == ref.wwords > 2
    assert np.array_equal(got, want)


@pytest.mark.parametrize("w,h,codec,q,ri,sub", [
    (256, 32, Codec.UYVY, 80, None, None),
    (80, 104, Codec.UYVY, 80, 3, None),
    (128, 128, Codec.YUYV, 80, None, "420"),
    (64, 64, Codec.RGB, 90, None, None),
    (1920, 1080, Codec.UYVY, 80, None, None),
])
def test_file_byte_equal_to_reference(w, h, codec, q, ri, sub):
    ref, enc = pair(w, h, codec, q, ri, sub)
    frame = frame_for(w, h, codec, 11)
    got = enc.encode(frame, device="cpu")
    assert bytes(got[:2]) == b"\xff\xd8" and bytes(got[-2:]) == b"\xff\xd9"
    assert np.array_equal(got, ref.encode(frame))


def test_front_end_summation_order_bound():
    """Below 64 MCUs XLA's CPU dot sums in another order.

    The port's front end is one fused multiply-add per k in ascending order
    (XLA's order for larger frames, and kernel K1's).  On this 8-MCU noise
    frame one of 2048 coefficients lands on the other side of a .5 and
    moves by one; everything after the front end is exact given equal
    coefficients (the cases above).  The bound: at most one coefficient, by
    at most one.
    """
    import jax.numpy as jnp

    ref, enc = pair(64, 16, Codec.UYVY, 80, 2)
    frame = frame_for(64, 16, Codec.UYVY, 7, "noise")
    W, const, bpr = ref._mega
    mb = frame[:, : ref.nmcux * bpr].reshape(ref.nmcuy, 8, ref.nmcux, bpr).transpose(0, 2, 1, 3)
    mb = mb.reshape(ref.nmcu, 8 * bpr)
    q_ref = np.asarray(jnp.round(jnp.dot(jnp.asarray(mb, jnp.float32), jnp.asarray(W)) - jnp.asarray(const)))
    q_port = enc.front_end(torch.as_tensor(frame)).numpy()
    diff = np.abs(q_ref - q_port)
    assert diff.max() <= 1
    assert int((diff != 0).sum()) <= 1


@pytest.mark.parametrize("kind", ["content", "noise"])
@pytest.mark.parametrize("codec,sub", [
    (Codec.UYVY, None), (Codec.YUYV, None), (Codec.UYVY, "420"), (Codec.YUYV, "420"),
    (Codec.RGB, None), (Codec.RGBA, None),
])
def test_compact_chain_equals_dense_chain(codec, sub, kind):
    """The front end skips the rows of W that are zero in a block group;
    the dense chain, one multiply-add per k over all rows in ascending k,
    gives the same coefficients bit for bit."""
    w, h = 128, 64
    enc = port_jpeg.JpegEncoder(w, h, in_codec=port_types.Codec(codec), quality=80, subsampling=sub)
    frame = torch.as_tensor(frame_for(w, h, codec, 17, kind))
    x = enc.mcu_bytes(frame).to(torch.float32)
    W = torch.as_tensor(enc.state["W"])
    acc = torch.zeros(x.shape[0], W.shape[1])
    for k in range(W.shape[0]):
        acc = torch.addcmul(acc, x[:, k: k + 1], W[k: k + 1])
    dense = torch.round(acc - torch.as_tensor(enc.state["const"])).to(torch.int64)
    assert torch.equal(enc.front_end(frame), dense)


def test_jpeg_compress_module_matches_reference():
    from ultragrid_tpu.modules.video_compress import JpegCompress as RefCompress
    from ultragrid_tpu_torch.modules.video_compress import JpegCompress

    data = frame_for(256, 64, Codec.UYVY, 13)
    frame = port_types.VideoFrame(port_types.VideoDesc(256, 64, port_types.Codec.UYVY, 30.0), [data],
                                  timestamp=1.5)
    ref_frame = VideoFrame(VideoDesc(256, 64, Codec.UYVY, 30.0), [data], timestamp=1.5)
    for cfg in ("", "90", "80:4", "80:0:420"):
        got = JpegCompress(cfg, device="cpu").compress(frame)
        want = RefCompress(cfg).compress(ref_frame)
        assert dataclasses.astuple(got.desc) == dataclasses.astuple(want.desc)
        assert got.desc.color_spec == Codec.JPEG
        assert got.timestamp == 1.5
        assert isinstance(got.data, DeviceFile) and got.data.device.type == "cpu"
        assert np.array_equal(got.data, np.asarray(want.data))
    # a frame already a tensor on the CPU: the file made there, left there
    tensor_frame = port_types.VideoFrame(frame.desc, [torch.as_tensor(data)], timestamp=1.5)
    got = JpegCompress("", device="cpu").compress(tensor_frame)
    assert isinstance(got.data, DeviceFile) and got.data.device.type == "cpu"
    assert np.array_equal(np.asarray(got.data), np.asarray(RefCompress("").compress(ref_frame).data))
    meta = port_types.VideoFrame(frame.desc, [torch.zeros((64, 512), dtype=torch.uint8, device="meta")])
    with pytest.raises(ValueError, match="tensor is on meta"):
        JpegCompress("", device="cpu").compress(meta)


def test_cpu_tensor_never_launches_a_kernel():
    from ultragrid_tpu_torch.ops import jpeg_cuda

    before = jpeg_cuda.LAUNCHES.count
    enc = port_jpeg.JpegEncoder(64, 16)
    enc.encode(frame_for(64, 16, Codec.UYVY, 1), device="cpu")
    assert jpeg_cuda.LAUNCHES.count == before
    with pytest.raises(ValueError, match="CUDA"):
        t = enc.tables("cpu")
        jpeg_cuda.fused_encode(torch.zeros(16, 128, dtype=torch.uint8), t["wc"], t["rows"], t["groups"],
                               t["const"], t["huff"], layout=0, nmcux=4, nmcuy=2, restart_interval=2,
                               wwords=16)


@pytest.mark.parametrize("table", ["DC_LUMA", "DC_CHROMA", "AC_LUMA", "AC_CHROMA"])
def test_pack_tables_byte_equal_to_reference(table):
    bits, vals = getattr(ref_jpeg, table + "_BITS"), getattr(ref_jpeg, table + "_VALS")
    got = port_jpeg.pack_tables(*port_jpeg.build_huffman(bits, vals))
    want = ref_jpeg.pack_tables(*ref_jpeg.build_huffman(bits, vals))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert port_jpeg.BYTES_PER_BLOCK_CAP == ref_jpeg.BYTES_PER_BLOCK_CAP


def test_jpeg_encode_core_equals_reference():
    """The single-shot encode returns the reference's seven parts (slots
    padded to the slot width, their bit lengths, the overflow flag), and
    they assemble to the file of ``JpegEncoder.encode`` (which the tests
    above hold to the reference's)."""
    w, h = 256, 32
    frame = frame_for(w, h, Codec.UYVY, 13)
    want = jax.tree.map(np.asarray, ref_jpeg.jpeg_encode_core(frame, w, Codec.UYVY, 80))
    got = port_jpeg.jpeg_encode_core(frame, w, port_types.Codec.UYVY, 80, device="cpu")
    assert all(t.device.type == "cpu" for t in got)
    assert_outputs_equal(want, got)
    enc = port_jpeg.JpegEncoder(w, h, quality=80)
    body = enc.assemble(*got[:-1])
    assert np.array_equal(np.concatenate([np.frombuffer(enc._header, np.uint8), body, [0xFF, 0xD9]]),
                          enc.encode(frame, device="cpu"))


def test_warm_leaves_the_encoder_as_it_was():
    """warm() runs the plain version on the CPU at the current width and
    its first escalation, and leaves the slot width and every later output
    as a cold encoder's."""
    frame = frame_for(256, 32, Codec.UYVY, 9, "noise")
    warm, cold = (port_jpeg.JpegEncoder(256, 32, quality=95) for _ in range(2))
    warm.warm(device="cpu")
    assert warm.wwords == cold.wwords == 32
    warm.warm(widths=(2, 64), device="cpu")
    assert warm.wwords == 32
    f = torch.as_tensor(frame)
    for a, b in zip(warm.encode_device(f), cold.encode_device(f)):
        assert torch.equal(a, b)
    assert np.array_equal(warm.encode(frame, device="cpu"), cold.encode(frame, device="cpu"))
    assert warm.wwords == cold.wwords


# the entropy assembly on tensors (ops/jpeg_assemble_cuda.py): its plain
# version against the host C assembly that both packages share, at every
# geometry K1 takes, on the slots of the CASES above and on the whole frame
# in one segment
ASSEMBLY_CASES = [c[:6] for c in CASES] + [(256, 32, Codec.UYVY, 80, 10 ** 6, None),
                                           (64, 64, Codec.UYVY, 90, 2, "444")]


@pytest.mark.parametrize("w,h,codec,q,ri,sub", ASSEMBLY_CASES)
def test_assembly_plain_is_the_c_assembly(w, h, codec, q, ri, sub):
    from ultragrid_tpu_torch.ops import jpeg_assemble_cuda

    enc = port_jpeg.JpegEncoder(w, h, in_codec=port_types.Codec(codec), quality=q,
                                restart_interval=ri if ri != 10 ** 6 else (w // 16) * (h // 8), subsampling=sub)
    frame = torch.as_tensor(frame_for(w, h, codec, 21, "noise" if q >= 90 else "content"))
    parts = enc.encode_plain(frame)
    while bool(parts[-1]):
        parts = enc.escalate_and_retry(frame)
    want = enc.assemble(*parts[:-1])
    got = jpeg_assemble_cuda.assemble_plain(*parts[:-1], ky=enc.ky, restart_interval=enc.restart_interval)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    asm = jpeg_assemble_cuda.Assembly(parts, ky=enc.ky, restart_interval=enc.restart_interval)
    with pytest.raises(ValueError, match="read first"):
        asm.write(torch.empty(want.size, dtype=torch.uint8))
    assert asm.read() == (False, want.size)
    out = torch.empty(want.size + 2, dtype=torch.uint8)
    asm.write(out, eoi=True)
    assert np.array_equal(out.numpy(), np.concatenate([want, [0xFF, 0xD9]]))
    with pytest.raises(ValueError, match="bytes for a body"):
        asm.write(out)


def random_slots(rng, nmcu, ky, ww, ones: bool):
    """K1-shaped parts of random bits (``ones``: most bits 1, so data bytes
    and pads make many 0xFF) and counts up to the slot's width."""
    def slots(n):
        s = rng.integers(0, 2 ** 32, (n, ww), dtype=np.uint64)
        if ones:
            s |= np.uint64(0xFFFFFF00FFFF0000)
        return torch.as_tensor((s & 0xFFFFFFFF).astype(np.uint32).view(np.int32))

    def bits(n):
        return torch.as_tensor(rng.integers(0, 32 * ww + 1, n).astype(np.int32))

    return [slots(nmcu * ky), bits(nmcu * ky), slots(nmcu), bits(nmcu), slots(nmcu), bits(nmcu)]


@pytest.mark.parametrize("seed", range(12))
def test_assembly_plain_stuffs_and_numbers_as_the_c_assembly(seed):
    """Random slots, many of their bytes 0xFF: the plain version against
    the C assembly, and from a later first segment against the C body with
    each marker counted on and the marker before its first segment."""
    from ultragrid_tpu_torch.ops import jpeg_assemble_cuda

    rng = np.random.default_rng(seed)
    ky, ww = (1, 2, 4)[seed % 3], (1, 2, 4)[seed // 3 % 3]
    nmcu = int(rng.integers(1, 60))
    ri = int(rng.integers(1, nmcu + 2))
    parts = random_slots(rng, nmcu, ky, ww, ones=seed % 2 == 1)
    enc = port_jpeg.JpegEncoder.__new__(port_jpeg.JpegEncoder)  # the C assembly's geometry alone
    enc.nmcu, enc.ky, enc.restart_interval = nmcu, ky, ri
    enc.nblocks, enc.nseg = nmcu * (ky + 2), -(-nmcu // ri)
    want = enc.assemble(*parts)
    got = jpeg_assemble_cuda.assemble_plain(*parts, ky=ky, restart_interval=ri)
    assert np.array_equal(got.numpy(), want)
    first = int(rng.integers(1, 30))
    body = want.copy()
    ff = np.flatnonzero(body[:-1] == 0xFF) + 1
    at = ff[(body[ff] & 0xF8) == 0xD0]
    assert at.size == enc.nseg - 1
    body[at] = 0xD0 | ((body[at] + first % 8) & 7)
    got = jpeg_assemble_cuda.assemble_plain(*parts, ky=ky, restart_interval=ri, first_segment=first, eoi=True)
    assert got.tolist() == [0xFF, 0xD0 + (first - 1) % 8] + body.tolist() + [0xFF, 0xD9]


@pytest.mark.parametrize("w,h,codec,q,ri,sub", [
    (256, 32, Codec.UYVY, 80, None, None),
    (128, 128, Codec.YUYV, 80, None, "420"),
    (64, 64, Codec.RGB, 90, None, None),
])
def test_encode_file_is_the_reference_file(w, h, codec, q, ri, sub):
    ref, enc = pair(w, h, codec, q, ri, sub)
    frame = frame_for(w, h, codec, 13)
    got = enc.encode_file(torch.as_tensor(frame))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8 and got.device.type == "cpu"
    assert np.array_equal(np.asarray(got), ref.encode(frame))


def test_encode_file_escalates_as_encode():
    ref, enc = pair(256, 32, Codec.UYVY, 95, None)
    ref.wwords = enc.wwords = 2
    frame = frame_for(256, 32, Codec.UYVY, 9, "noise")
    got = enc.encode_file(torch.as_tensor(frame))
    want = ref.encode(frame)
    assert enc.wwords == ref.wwords > 2 and np.array_equal(np.asarray(got), want)
