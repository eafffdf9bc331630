"""Kernels K1 and K2 on the card against their plain PyTorch twins, the
receive path, the JPEG entropy decode on the card against the C scan
decoder (coefficients and pixels equal, one launch a frame, the same
refusals and the same reading of a missing last extension, the C path for
streams without restart markers), the batched sender, the pixel formats, DXT, postprocess, the
filters, the local loop, the stitcher, the H.264 device encoders, the
wavelet and intra codecs and the audio RS parity on the card against the
CPU, the import capture of a recording on the card, the standards-mode
JPEG round trip (K1, RFC 2435, the decode), thumbnailgen, and the
multi-device path (four row bands on one card: the sender step at 8K, the
receiver step, the halo deinterlace, sharded H.264, the dry run) on the card.

Needs a CUDA card and nvcc; skips without a card.  On the card's machine
(which has no jax, so the JAX conftest must stay out):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

K1 sums each coefficient as a fused multiply-add chain over the non-zero
rows of its block group in ascending k, the order of the plain front end, so
both are bit-equal even under the real mega matrix; K2 and the peel are
integer work.  Tolerance: exact equality, except the JPEG decode, whose
float32 product on the card is ``torch.matmul``: at most 0.1% of the output
bytes may differ from the CPU's chain, each by at most 1; and DXT, at most
0.1% of the blocks (the port fixes one order and one rounding per fused
multiply-add on both devices, so 0 is expected).  Postprocess, filters and
the loop: byte-equal (the same float32 roundings on both devices); H.264:
byte-equal access units (integer code, and the Exp-Golomb bit length's
float step is fixed up to the exact integer).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ultragrid_tpu_torch.models.encode import (  # noqa: E402
    BatchedJpegLdgmPipeline, EncodeConfig, EncodePipeline)
from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress  # noqa: E402
from ultragrid_tpu_torch.ops import dxt, fec, jpeg_cuda, pixfmt  # noqa: E402
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, vc_get_linesize  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def content(w, h, codec, seed):
    ls = vc_get_linesize(w, codec)
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, ls, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


@pytest.mark.parametrize("w,h,codec,q,ri,sub", [
    (1920, 1080, Codec.UYVY, 80, None, None),
    (1024, 512, Codec.UYVY, 80, None, "420"),
    (1024, 512, Codec.YUYV, 95, None, None),
    (1024, 512, Codec.RGB, 80, None, None),
    (1024, 512, Codec.RGBA, 90, 7, None),
    (80, 104, Codec.UYVY, 80, 3, None),
    # restart intervals: every MCU, a non-divisor of the row, one segment
    # for the frame; tiles of 16 MCUs start inside segments
    (1920, 1080, Codec.UYVY, 80, 1, None),
    (1920, 1080, Codec.UYVY, 80, 7, None),
    (1920, 1080, Codec.UYVY, 80, 16200, None),
    (272, 48, Codec.UYVY, 80, 5, "420"),
])
def test_k1_matches_plain(cuda, w, h, codec, q, ri, sub):
    enc = JpegEncoder(w, h, in_codec=codec, quality=q, restart_interval=ri, subsampling=sub)
    frame = torch.as_tensor(content(w, h, codec, 1)).to(cuda)
    before = jpeg_cuda.LAUNCHES.count
    got = enc._encode(frame)
    assert jpeg_cuda.LAUNCHES.count == before + 1
    want = enc.encode_plain(frame)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_k1_overflow_and_escalation(cuda):
    enc = JpegEncoder(256, 64, quality=95)
    enc.wwords = 2
    frame_np = np.random.default_rng(2).integers(0, 256, (64, 512), dtype=np.uint8)
    got = enc._encode(torch.as_tensor(frame_np).to(cuda))
    assert bool(got[-1])
    file_gpu = enc.encode(torch.as_tensor(frame_np).to(cuda))
    cpu = JpegEncoder(256, 64, quality=95)
    cpu.wwords = 2
    assert np.array_equal(file_gpu, cpu.encode(frame_np, device="cpu")) and enc.wwords == cpu.wwords


@pytest.mark.parametrize("sub", [None, "444"])
def test_k1_warm_then_escalation(cuda, sub):
    """warm() on the card launches K1 (or its per-plane entry) once at the
    slot width and once at its escalation and leaves the width as it was;
    the escalated file then equals the CPU's."""
    frame_np = np.random.default_rng(6).integers(0, 256, (64, 512), dtype=np.uint8)
    enc = JpegEncoder(256, 64, quality=95, subsampling=sub)
    enc.wwords = 4
    counter = jpeg_cuda.PLANE_LAUNCHES if sub else jpeg_cuda.LAUNCHES
    before = counter.count
    enc.warm()
    assert counter.count - before == 2 and enc.wwords == 4
    file_gpu = enc.encode(torch.as_tensor(frame_np).to(cuda))
    cpu = JpegEncoder(256, 64, quality=95, subsampling=sub)
    cpu.wwords = 4
    assert np.array_equal(file_gpu, cpu.encode(frame_np, device="cpu")) and enc.wwords == cpu.wwords > 4


def test_jpeg_encode_core_on_the_card(cuda):
    """One K1 launch, the seven parts equal to the CPU's."""
    from ultragrid_tpu_torch.ops.jpeg import jpeg_encode_core

    frame_np = content(256, 64, Codec.UYVY, 7)
    before = jpeg_cuda.LAUNCHES.count
    got = jpeg_encode_core(torch.as_tensor(frame_np).to(cuda), 256, Codec.UYVY, 80)
    assert jpeg_cuda.LAUNCHES.count - before == 1 and all(t.is_cuda for t in got)
    for a, b in zip(got, jpeg_encode_core(frame_np, 256, Codec.UYVY, 80, device="cpu")):
        assert torch.equal(a.cpu(), b)


def test_k2_matches_plain(cuda):
    mask = fec.build_ldgm_matrix(256, 26, 5, 1)
    par = fec.make_gf2_parity(mask, 1001)
    data = torch.randint(-2**31, 2**31 - 1, (256, 1001), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4)).to(cuda)
    before = fec.LAUNCHES.count
    got = par(data)
    assert fec.LAUNCHES.count == before + 1
    assert torch.equal(got, par.plain(data))
    assert torch.equal(got.cpu(), par.plain(data.cpu()))


@pytest.mark.parametrize("w,h", [(1920, 1080), (7680, 2160)])
def test_k2_fused_matches_plain_on_pipeline_parts(cuda, w, h):
    pipe = EncodePipeline(VideoDesc(w, h, Codec.UYVY, 60.0), EncodeConfig(compress="jpeg", fec="ldgm:256:26:5"))
    gen = torch.Generator().manual_seed(w)
    parts = [torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32, generator=gen).to(cuda)
             for n in pipe.part_words]
    before = fec.LAUNCHES.count
    got = pipe.parity(*parts)
    assert fec.LAUNCHES.count == before + 1
    assert torch.equal(got, pipe.parity.plain(*parts))


def test_pipeline_on_card_equals_cpu(cuda):
    desc = VideoDesc(1920, 1080, Codec.UYVY, 60.0)
    cfg = EncodeConfig(compress="jpeg", fec="ldgm:256:26:5")
    frame = content(1920, 1080, Codec.UYVY, 3)
    gpu = EncodePipeline(desc, cfg)(frame)
    cpu = EncodePipeline(desc, cfg, device="cpu")(frame)
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu(), b)


def test_pipeline_never_moves_a_tensor_between_devices(cuda):
    desc = VideoDesc(256, 64, Codec.UYVY, 60.0)
    cfg = EncodeConfig(compress="jpeg", fec="ldgm:32:16:5")
    frame = content(256, 64, Codec.UYVY, 5)
    on_cpu, on_card = EncodePipeline(desc, cfg, device="cpu"), EncodePipeline(desc, cfg)
    before = (jpeg_cuda.LAUNCHES.count, fec.LAUNCHES.count)
    with pytest.raises(ValueError, match="tensor is on cuda:0.*runs on cpu"):
        on_cpu(torch.as_tensor(frame).to(cuda))
    with pytest.raises(ValueError, match="tensor is on cpu.*runs on cuda"):
        on_card(torch.as_tensor(frame))
    assert (jpeg_cuda.LAUNCHES.count, fec.LAUNCHES.count) == before
    # an array goes to the pipeline's device, a tensor there is taken as is
    outs = on_card(frame)
    assert all(o.is_cuda for o in outs)
    assert (jpeg_cuda.LAUNCHES.count, fec.LAUNCHES.count) == (before[0] + 1, before[1] + 1)
    for a, b in zip(outs, on_card(torch.as_tensor(frame).to(cuda))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,m,c,ps", [
    (256, 26, 5, 1880),  # the 1080p receive path
    (512, 384, 5, 1000),  # the default spec
    (1500, 750, 8, 120),  # the tallest suggested configurations
    (1500, 1500, 8, 2768),
    (6000, 3000, 8, 692),  # past the default layout: the TALL variant
])
def test_k2_both_staircases_match_plain(cuda, k, m, c, ps):
    sess = fec.LdgmSession(k, m, c)
    gen = torch.Generator().manual_seed(k + m)
    block = torch.randint(0, 256, (k + m, ps), dtype=torch.uint8, generator=gen).to(cuda)
    words = fec.symbol_words(block)
    par = sess.peel_parity(cuda)[0].with_width(words.shape[1])
    before = fec.LAUNCHES.count
    got = par(words)
    assert fec.LAUNCHES.count == before + 1
    assert torch.equal(got, par.plain(words))
    enc = sess.encode_device(block[:k])
    assert fec.LAUNCHES.count == before + 2
    want = fec.Gf2Parity(sess.matrix, words.shape[1]).plain(words[:k].contiguous())
    assert torch.equal(enc, want.view(torch.uint8)[:, :ps])


@pytest.mark.parametrize("trial,nloss", [(0, 5), (1, 12), (2, 16), (3, 30)])
def test_peel_on_card_equals_cpu(cuda, trial, nloss):
    sess = fec.LdgmSession(64, 16, 5)
    frame = np.random.default_rng(3).integers(0, 256, 5001, dtype=np.uint8)
    buf, desc = sess.encode(frame)
    sym = buf.reshape(-1, desc.symbol_size).copy()
    r = np.random.default_rng(trial)
    present = np.ones(sym.shape[0], bool)
    present[r.choice(sym.shape[0], nloss, replace=False)] = False
    want = sess.decode_device(sym, present, device="cpu")
    rounds = sess.rounds
    before = fec.LAUNCHES.count
    got = sess.decode_device(torch.as_tensor(sym).to(cuda), present)
    assert sess.rounds == rounds and fec.LAUNCHES.count == before + rounds
    assert (got is None) == (want is None)
    if want is not None:
        assert np.array_equal(got, want) and np.array_equal(got, frame)


@pytest.mark.parametrize("w,h,q,sub,out_codec", [
    (1920, 1088, 80, "422", Codec.UYVY), (1920, 1088, 80, "420", Codec.UYVY),
    (1920, 1088, 80, "422", Codec.RGB),
    (512, 128, 100, "422", Codec.UYVY),  # noise at q100: the int16 upload
])
def test_decode_on_card_within_tolerance_of_cpu(cuda, w, h, q, sub, out_codec):
    if q == 100:
        src = np.random.default_rng(0).integers(0, 256, (h, 2 * w), dtype=np.uint8)
    else:
        src = content(w, h, Codec.UYVY, 9)
    data = JpegEncoder(w, h, quality=q, subsampling=sub).encode(src, device="cpu")
    frame = VideoFrame(VideoDesc(w, h, Codec.JPEG, 60.0), [data])
    got = JpegDecompress().decompress(frame, out_codec).data
    want = JpegDecompress(device="cpu").decompress(frame, out_codec).data
    assert got.is_cuda and got.shape == want.shape
    d = (got.cpu().long() - want.long()).abs()
    assert int(d.max()) <= 1 and int((d != 0).sum()) <= 0.001 * d.numel()


def test_truncated_stream_on_card_as_on_cpu(cuda):
    data = JpegEncoder(256, 64).encode(content(256, 64, Codec.UYVY, 2), device="cpu")
    for cut, want in ((data[:-2], None), (data[: len(data) // 2], IndexError)):
        frame = VideoFrame(VideoDesc(256, 64, Codec.JPEG, 60.0), [cut])
        if want is not None:
            for dev in ("cuda", "cpu"):
                with pytest.raises(want):
                    JpegDecompress(device=dev).decompress(frame, Codec.UYVY)
            continue
        got = JpegDecompress().decompress(frame, Codec.UYVY).data
        assert got.is_cuda
        d = (got.cpu().long() - JpegDecompress(device="cpu").decompress(frame, Codec.UYVY).data.long()).abs()
        assert int(d.max()) <= 1 and int((d != 0).sum()) <= 0.001 * d.numel()


@pytest.mark.parametrize("w,h,q,ri,noise", [
    (1920, 1080, 80, None, False), (1920, 1080, 95, 1, False), (3840, 2160, 80, None, False),
    (208, 56, 50, None, False),
    (512, 128, 100, None, True),  # noise at q100: more exceptions than the packed upload takes
])
def test_card_entropy_decode_equals_c_decoder(cuda, w, h, q, ri, noise):
    from ultragrid_tpu_torch.ops import jpeg_decode_cuda
    from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, entropy_decode_422

    src = (np.random.default_rng(0).integers(0, 256, (h, 2 * w), dtype=np.uint8) if noise
           else content(w, h, Codec.UYVY, 9))
    data = bytes(JpegEncoder(w, h, quality=q, restart_interval=ri).encode(src, device="cpu"))
    hdr, (cy, cu, cv), nmcux, nmcuy = entropy_decode_422(data)
    nmcu = nmcux * nmcuy
    want = torch.cat([torch.as_tensor(cy).view(nmcu, 128), torch.as_tensor(cu), torch.as_tensor(cv)], 1).float()
    file = torch.zeros(len(data) + jpeg_decode_cuda.PAD, dtype=torch.uint8, device=cuda)
    file[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(cuda)
    tables = torch.as_tensor(jpeg_decode_cuda.huffman_tables(hdr["htabs"])).to(cuda)
    before = jpeg_decode_cuda.LAUNCHES.count
    q, status = jpeg_decode_cuda.segment_decode(file, len(data), hdr["scan_start"], tables,
                                                tuple(c["td"] for c in hdr["scan"]), nmcu, hdr["ri"])
    assert jpeg_decode_cuda.LAUNCHES.count == before + 1
    assert status.tolist() == [0, nmcu, -(-nmcu // hdr["ri"]) - 1, 0]
    assert torch.equal(q.cpu(), want)

    dec = JpegDecoder(cuda)
    before, refused = jpeg_decode_cuda.LAUNCHES.count, jpeg_decode_cuda.REFUSED.count
    for _ in range(3):
        got, gh, gw = dec.decode_to_uyvy(data)
    assert jpeg_decode_cuda.LAUNCHES.count == before + 3 and dec.host_scans == 0
    assert jpeg_decode_cuda.REFUSED.count == refused
    host, hh, hw = dec._decode_on_host(data)
    assert dec.host_scans == 1 and (gh, gw) == (hh, hw) == (h, w)
    assert got.is_cuda and torch.equal(got, host)


def test_card_entropy_decode_falls_back_to_the_c_path(cuda):
    from tests.test_torch_jpeg_decode import trim_segments
    from ultragrid_tpu_torch.ops import jpeg_decode_cuda
    from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, _parse_headers

    w, h = 208, 56
    good = bytes(JpegEncoder(w, h).encode(content(w, h, Codec.UYVY, 3), device="cpu"))
    hdr = _parse_headers(good)
    rst = [i for i in range(hdr["scan_start"], len(good) - 1) if good[i] == 0xFF and 0xD0 <= good[i + 1] <= 0xD7]
    bad = bytearray(good)
    for i in range(rst[39] + 2, rst[40] - 1, 2):  # segment 40: all-ones bits, no code of the tables
        bad[i: i + 2] = b"\xff\x00"
    i = good.index(b"\xff\xdd")
    one = bytes(JpegEncoder(w, h, restart_interval=91).encode(content(w, h, Codec.UYVY, 3), device="cpu"))
    no_dri = one[:i] + one[i + 6:]
    dec = JpegDecoder(cuda)
    before, refused = jpeg_decode_cuda.LAUNCHES.count, jpeg_decode_cuda.REFUSED.count
    with pytest.raises(ValueError):
        dec.decode_to_uyvy(bytes(bad))
    with pytest.raises(ValueError):
        dec._decode_on_host(bytes(bad))  # the C path stops at the same segment
    assert jpeg_decode_cuda.LAUNCHES.count == before + 1 and dec.host_scans == 1
    assert jpeg_decode_cuda.REFUSED.count == refused + 1
    got = dec.decode_to_uyvy(no_dri)[0]
    assert jpeg_decode_cuda.LAUNCHES.count == before + 1 and dec.host_scans == 2
    assert torch.equal(got, JpegDecoder(cuda)._decode_on_host(no_dri)[0])
    got = dec.decode_to_uyvy(good)[0]
    assert jpeg_decode_cuda.LAUNCHES.count == before + 2 and dec.host_scans == 2
    assert torch.equal(got, dec._decode_on_host(good)[0])
    # segments whose last symbol's extension is cut: 0, as the C decoder
    # reads it; a segment cut further: refused by both
    noise = np.random.default_rng(4).integers(0, 256, (h, 2 * w), dtype=np.uint8)
    trimmed, cut, cut_further = trim_segments(bytes(JpegEncoder(w, h, quality=100, restart_interval=1)
                                                .encode(noise, device="cpu")))
    assert len(cut) >= 10
    got = dec.decode_to_uyvy(trimmed)[0]
    assert jpeg_decode_cuda.LAUNCHES.count == before + 3 and dec.host_scans == 3
    assert torch.equal(got, dec._decode_on_host(trimmed)[0])
    with pytest.raises(ValueError):
        dec.decode_to_uyvy(cut_further)
    assert jpeg_decode_cuda.LAUNCHES.count == before + 4 and jpeg_decode_cuda.REFUSED.count == refused + 2


def test_rs_encode_on_card_equals_cpu(cuda):
    sess = fec.RsSession(200, 240)
    payload = np.random.default_rng(6).integers(0, 256, 150000, dtype=np.uint8)
    got, desc = sess.encode(payload)
    want, _ = sess.encode(payload, device="cpu")
    assert np.array_equal(got, want)
    sym = got.reshape(240, desc.symbol_size).copy()
    present = np.ones(240, bool)
    present[np.random.default_rng(1).choice(240, 40, replace=False)] = False
    sym[~present] = 0
    assert np.array_equal(sess.decode(sym, present), payload)


@pytest.mark.parametrize("nframes", [1, 2, 5])
def test_k2_frame_axis_matches_plain_and_single_launches(cuda, nframes):
    """K2 with a frame axis: one launch for all frames, equal to its plain
    version and to one single-frame launch per frame."""
    pipe = EncodePipeline(VideoDesc(1920, 1088, Codec.UYVY, 60.0), EncodeConfig(compress="jpeg", fec="ldgm:256:26:5"))
    mask = pipe.state["ldgm_mask"][:, : sum(pipe.row_counts)]
    batch = fec.make_gf2_parity(mask, pipe.psw, part_words=pipe.part_words, frames=nframes)
    gen = torch.Generator().manual_seed(nframes)
    parts = [torch.randint(-2**31, 2**31 - 1, (nframes * n,), dtype=torch.int32, generator=gen).to(cuda)
             for n in pipe.part_words]
    before = fec.LAUNCHES.count
    got = batch(*parts)
    assert fec.LAUNCHES.count == before + 1
    assert torch.equal(got, batch.plain(*parts))
    got = got.reshape(nframes, pipe.m, pipe.psw)
    for f in range(nframes):
        one = pipe.parity(*[p[f * n: (f + 1) * n] for p, n in zip(parts, pipe.part_words)])
        assert torch.equal(got[f], one)


@pytest.mark.parametrize("w,h,sub,b", [(1920, 1088, "420", 3), (1920, 1080, None, 2)])
def test_batched_pipeline_on_card_equals_single_steps(cuda, w, h, sub, b):
    desc = VideoDesc(w, h, Codec.UYVY, 60.0)
    frames = np.stack([content(w, h, Codec.UYVY, 20 + i) for i in range(b)])
    batch = BatchedJpegLdgmPipeline(desc, b, fec="ldgm:256:26:5", subsampling=sub)
    single = EncodePipeline(desc, EncodeConfig(compress="jpeg", subsampling=sub, fec="ldgm:256:26:5"))
    before = (jpeg_cuda.LAUNCHES.count, fec.LAUNCHES.count)
    outs = batch(frames)
    assert (jpeg_cuda.LAUNCHES.count, fec.LAUNCHES.count) == (before[0] + 1, before[1] + 1)
    enc = single.jpeg_encoder
    for i in range(b):
        ref = single(frames[i])
        sl, sc = slice(i * enc.nmcu * enc.ky, (i + 1) * enc.nmcu * enc.ky), slice(i * enc.nmcu, (i + 1) * enc.nmcu)
        for got, want in zip((outs[0][sl], outs[1][sl], outs[2][sc], outs[3][sc], outs[4][sc], outs[5][sc],
                              outs[6][i]), ref[:7]):
            assert torch.equal(got, want)


@pytest.mark.parametrize("compress,in_codec,fec_spec", [
    ("none", Codec.UYVY, "ldgm:256:26:5"), ("dxt1", Codec.UYVY, "ldgm:256:26:5"), ("dxt5", Codec.RGB, "rs:200:240"),
])
def test_fixed_size_pipeline_on_card_equals_cpu(cuda, compress, in_codec, fec_spec):
    desc = VideoDesc(1920, 1080, in_codec, 60.0)
    cfg = EncodeConfig(in_codec=in_codec, compress=compress, fec=fec_spec)
    frame = content(1920, 1080, in_codec, 7)
    gpu, cpu = EncodePipeline(desc, cfg), EncodePipeline(desc, cfg, device="cpu")
    before = fec.LAUNCHES.count
    (data_g, par_g), (data_c, par_c) = gpu(frame), cpu(frame)
    assert fec.LAUNCHES.count == before + (1 if fec_spec.startswith("ldgm") else 0)
    assert torch.equal(data_g.cpu(), data_c) and torch.equal(par_g.cpu(), par_c)
    if fec_spec.startswith("ldgm"):
        buf, d = fec.LdgmSession(256, 26, 5).encode(data_c.numpy())
        assert np.array_equal(buf[256 * d.symbol_size:].reshape(26, -1), par_c.numpy())


@pytest.mark.parametrize("pair", [(Codec.UYVY, Codec.RGB), (Codec.v210, Codec.RG48), (Codec.R10k, Codec.Y416),
                                  (Codec.RG48, Codec.v210), (Codec.R12L, Codec.UYVY), (Codec.Y416, Codec.R12L),
                                  (Codec.DVS10, Codec.v210), (Codec.VUYA, Codec.RGB)],
                         ids=lambda p: f"{p[0].name}->{p[1].name}")
def test_conversion_on_card_equals_cpu(cuda, pair):
    from ultragrid_tpu_torch.types import vc_get_linesize

    src = np.random.default_rng(int(pair[0])).integers(0, 256, (1080, vc_get_linesize(1920, pair[0])),
                                                      dtype=np.uint8)
    got = pixfmt.convert_frame(src, 1920, *pair)
    assert got.is_cuda
    assert torch.equal(got.cpu(), pixfmt.convert_frame(src, 1920, *pair, device="cpu"))


@pytest.mark.parametrize("name,bpp,bpb", [("dxt1_encode_rgb", 3, 8), ("dxt1_encode_uyvy", 2, 8),
                                          ("dxt1_yuv_encode_uyvy", 2, 8), ("dxt5_ycocg_encode_rgb", 3, 16)])
def test_dxt_on_card_equals_cpu(cuda, name, bpp, bpb):
    w, h = 1920, 1080
    src = np.ascontiguousarray(content(w, h, Codec.RGB, 8)[:, : bpp * w])
    got = getattr(dxt, name)(torch.as_tensor(src).to(cuda), w)
    want = getattr(dxt, name)(torch.as_tensor(src), w)
    nd = int((got.cpu().reshape(-1, bpb) != want.reshape(-1, bpb)).any(dim=1).sum())
    assert nd <= 0.001 * (w * h // 16)
    dec = dxt.dxt1_decode_rgb if bpb == 8 else dxt.dxt5_ycocg_decode_rgb
    assert torch.equal(dec(want.to(cuda), w, h).cpu(), dec(want, w, h))


# ---- the local loop: postprocess, filters, displays on the card ----

PP_CASES = [
    ("deinterlace_blend", Codec.UYVY), ("deinterlace_blend", Codec.v210), ("deinterlace_linear", Codec.Y216),
    ("mirror", Codec.UYVY), ("mirror", Codec.RGB), ("gamma_correct", Codec.RGB), ("grayscale", Codec.RGB),
    ("grayscale", Codec.UYVY), ("color_matrix", Codec.RGBA), ("logo_blit", Codec.RGB),
    ("matrix2_uyvy", Codec.UYVY), ("scale_bilinear_rgb", Codec.RGB), ("blank_region", Codec.UYVY),
]


def _pp_call(name, src, codec, w):
    from ultragrid_tpu_torch.ops import postprocess as pp

    rng = np.random.default_rng(3)
    args = {
        "deinterlace_blend": (codec,), "deinterlace_linear": (codec,), "mirror": (w, codec),
        "gamma_correct": (2.2,), "grayscale": (w, codec),
        "color_matrix": (w, codec, np.array([[0.299, 0.587, 0.114], [0.5, -0.4187, -0.0813], [-0.1687, -0.3313, 0.5]])),
        "logo_blit": (w, codec, rng.integers(0, 256, (64, 96, 4), dtype=np.uint8), 10, 20),
        "matrix2_uyvy": (w, np.array([1, -0.11555, -0.207938, 0, 1.01864, 0.114618, 0, 0.075049, 1.025327])),
        "scale_bilinear_rgb": (w, codec, 1280, 720), "blank_region": (w, codec, 100, 50, 300, 200),
    }[name]
    return getattr(pp, name)(src, *args)


@pytest.mark.parametrize("name,codec", PP_CASES, ids=[f"{n}-{c.name}" for n, c in PP_CASES])
def test_postprocess_on_card_equals_cpu(cuda, name, codec):
    w = 1920
    src = torch.as_tensor(content(w, 1080, codec, 9))
    got = _pp_call(name, src.to(cuda), codec, w)
    assert got.is_cuda
    assert torch.equal(got.cpu(), _pp_call(name, src, codec, w))


def test_filter_chain_stays_on_card_and_equals_cpu(cuda):
    from ultragrid_tpu_torch.modules.filters import FilterChain
    from ultragrid_tpu_torch.utils.pattern import generate_pattern

    spec = "deinterlace:blend,mirror,border,text:t=UG,crop:1280:720:8:8,scale:640:360,interlace"
    src = generate_pattern(1920, 1080, Codec.UYVY, "smpte_bars", device="cpu")
    assert torch.equal(generate_pattern(1920, 1080, Codec.UYVY, "smpte_bars").cpu(), src)
    desc = VideoDesc(1920, 1080, Codec.UYVY, 60.0)
    got = FilterChain(spec).apply(VideoFrame(desc, [src.to(cuda)]))
    want = FilterChain(spec).apply(VideoFrame(desc, [src]))
    assert got.data.is_cuda and torch.equal(got.data.cpu(), want.data)
    gen = FilterChain("noise:20").apply(VideoFrame(desc, [src.to(cuda)])).data
    assert gen.is_cuda and int((gen.long() - src.to(cuda).long()).abs().max()) <= 20


def test_local_loop_on_card_equals_cpu(cuda):
    from ultragrid_tpu_torch.modules.extra_displays import register_pipe_delegate
    from ultragrid_tpu_torch.pipeline.loop import run_local_pipeline

    got, want = [], []
    register_pipe_delegate("card", got.append)
    register_pipe_delegate("host", want.append)
    args = ("testcard:s=1920x1080:f=240:c=UYVY", 12, "deinterlace:blend,mirror,border", "scale:960x540")
    assert run_local_pipeline(args[0], "pipe:card", *args[1:]) == 12
    assert run_local_pipeline(args[0], "pipe:host", *args[1:], device="cpu") == 12
    assert len(got) == len(want) == 13
    for g, w in zip(got[:-1], want[:-1]):
        assert g.data.is_cuda and torch.equal(g.data.cpu(), w.data)


def test_stitch_on_card_equals_cpu(cuda):
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture

    spec = ("stitch:testcard:s=640x480:f=240:c=UYVY:p=smpte_bars#testcard:s=640x480:f=240:c=RGB:p=noise"
            ";size=1024x512")
    gpu, cpu = initialize_video_capture(spec), initialize_video_capture(spec, device="cpu")
    (g, _), (c, _) = gpu.grab(), cpu.grab()
    assert g.data.is_cuda and torch.equal(g.data.cpu(), c.data)


# ---- slice 6: the live session ----


def test_loop_built_under_a_side_stream_runs_on_the_default_stream(cuda):
    """P3: a pipeline built under a side stream keeps that stream, and both
    its threads enqueue there, so run() on the default stream shows the
    same frames as the CPU path."""
    from ultragrid_tpu_torch.modules.extra_displays import register_pipe_delegate
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.modules.video_display import initialize_video_display
    from ultragrid_tpu_torch.pipeline.loop import CaptureToDisplayPipeline, run_local_pipeline

    got, want = [], []
    register_pipe_delegate("side", got.append)
    register_pipe_delegate("side_host", want.append)
    spec, n = "testcard:s=1920x1080:f=240:c=UYVY", 12
    chain, post = "deinterlace:blend,mirror,border", "scale:960x540"
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        pipe = CaptureToDisplayPipeline(initialize_video_capture(spec), initialize_video_display("pipe:side"),
                                        n, chain, post)
    assert pipe.stream == side and torch.cuda.current_stream() != side
    assert pipe.run() == n
    torch.cuda.synchronize()
    assert run_local_pipeline(spec, "pipe:side_host", n, chain, post, device="cpu") == n
    assert len(got) == len(want) == n + 1
    for g, w in zip(got[:-1], want[:-1]):
        assert g.data.is_cuda and torch.equal(g.data.cpu(), w.data)


@pytest.mark.parametrize("w,h,codec,sub,q,ri", [
    (1920, 1080, Codec.UYVY, "444", 80, None), (1920, 1080, Codec.YUYV, "444", 95, None),
    (1920, 1080, Codec.RGB, "422", 80, None), (1920, 1080, Codec.RGBA, "422", 90, None),
    (96, 40, Codec.UYVY, "444", 80, None),
    # restart intervals: every MCU, and a non-divisor of the MCU row, so that
    # tiles of 16 MCUs start inside segments and recompute the DC before them
    (1920, 1080, Codec.UYVY, "444", 80, 1), (1920, 1080, Codec.YUYV, "444", 95, 7),
    (1920, 1080, Codec.RGB, "422", 80, 7), (1920, 1080, Codec.RGBA, "422", 90, 1),
])
def test_k1_coefficient_entry_matches_plain(cuda, w, h, codec, sub, q, ri):
    """The per-plane geometries: one launch of K1's per-plane entry (frame
    bytes in, slots out) equals its plain version (the PyTorch front end,
    then symbols and pack) bit for bit, whose front end on the card equals
    the CPU's, and the file equals the CPU's."""
    enc = JpegEncoder(w, h, in_codec=codec, quality=q, restart_interval=ri, subsampling=sub)
    assert enc.per_plane
    src = content(w, h, codec, 3)
    frame = torch.as_tensor(src).to(cuda)
    assert torch.equal(enc.plane_coefficients(frame).cpu(), enc.plane_coefficients(torch.as_tensor(src)))
    before, fused = jpeg_cuda.PLANE_LAUNCHES.count, jpeg_cuda.LAUNCHES.count
    got = enc._encode(frame)
    assert jpeg_cuda.PLANE_LAUNCHES.count == before + 1 and jpeg_cuda.LAUNCHES.count == fused
    want = enc.encode_plain(frame)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert np.array_equal(enc.encode(frame), enc.encode(torch.as_tensor(src)))


@pytest.mark.parametrize("codec,sub", [(Codec.UYVY, "444"), (Codec.YUYV, "444"), (Codec.RGB, "422"),
                                       (Codec.RGBA, "422")])
def test_k1_per_plane_overflow_and_escalation(cuda, codec, sub):
    """Slots of 2 words cannot hold noise at q95: the per-plane entry flags
    the overflow with the plain version's truncated slots and full bit
    counts, and encode() escalates to the CPU's file."""
    w, h = 256, 64
    frame_np = np.random.default_rng(4).integers(0, 256, (h, vc_get_linesize(w, codec)), dtype=np.uint8)
    frame = torch.as_tensor(frame_np).to(cuda)
    enc = JpegEncoder(w, h, in_codec=codec, quality=95, subsampling=sub)
    enc.wwords = 2
    got, want = enc._encode(frame), enc.encode_plain(frame)
    assert bool(got[-1]) and bool(want[-1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    before = jpeg_cuda.PLANE_LAUNCHES.count
    file_gpu = enc.encode(frame)
    assert jpeg_cuda.PLANE_LAUNCHES.count - before >= 2  # the 2-word launch and at least one wider
    cpu = JpegEncoder(w, h, in_codec=codec, quality=95, subsampling=sub)
    cpu.wwords = 2
    assert np.array_equal(file_gpu, cpu.encode(frame_np, device="cpu")) and enc.wwords == cpu.wwords > 2


def _free_port_pair():
    import socket

    for _ in range(64):
        a = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        a.bind(("", 0))
        p = a.getsockname()[1]
        b = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            b.bind(("", p + 1))
        except OSError:
            continue
        finally:
            a.close()
            b.close()
        return p
    raise RuntimeError("no free UDP port pair")


@pytest.mark.parametrize("compress,fec", [("jpeg:80", "ldgm:256:26:5"), ("none", "none")])
def test_live_session_1080p_on_card(cuda, compress, fec):
    """Sender -> 127.0.0.1 -> receiver at 1080p on the card: every displayed
    frame is on the card and equals the CPU plain path's (the testcard frame
    itself uncompressed; its encode -> decode within 0.1% of bytes off by 1
    for JPEG)."""
    import threading

    from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver
    from ultragrid_tpu_torch.pipeline.sender import VideoSender
    from ultragrid_tpu_torch.utils import params
    from ultragrid_tpu_torch.utils.pattern import generate_pattern

    params.set_commandline_param("ldgm-device", "device")
    try:
        port = _free_port_pair()
        recv = VideoReceiver("dummy", rx_port=port, frame_limit=10, timeout=30.0)
        shown = []
        orig = recv.display.put_frame

        def put(frame, blocking=True):
            if frame is not None:
                shown.append(frame.data.clone())
            orig(frame, blocking)

        recv.display.put_frame = put
        t = threading.Thread(target=recv.run, daemon=True)
        t.start()
        VideoSender("testcard:s=1920x1080:f=60:c=UYVY:still=1", "127.0.0.1", compress_spec=compress,
                    fec_spec=fec, tx_port=port, mtu=9000, frame_limit=40).run()
        t.join(timeout=30)
        assert not t.is_alive() and len(shown) >= 10
    finally:
        params.reset_params()
    src = generate_pattern(1920, 1080, Codec.UYVY, "bars", device="cpu")
    if compress == "none":
        want = src
    else:
        desc = VideoDesc(1920, 1080, Codec.JPEG, 60.0)
        file_cpu = JpegEncoder(1920, 1080).encode(src)
        want = JpegDecompress(device="cpu").decompress(VideoFrame(desc, [file_cpu]), Codec.UYVY).data
    # UDP on localhost may drop a packet; the receiver then shows the frame
    # with the hole zero-filled, as the reference does: every frame that
    # arrived whole must equal the CPU plain path
    whole = 0
    for g in shown:
        assert g.is_cuda and g.shape == want.shape
        d = (g.cpu().long() - want.long()).abs()
        whole += int(d.max()) <= 1 and int((d != 0).sum()) <= 0.001 * d.numel()
    assert whole >= max(1, len(shown) - recv.rx_state.frames_missing_data)


# ---- the H.264 device encoders at 1080p: the card against the CPU ----

def _h264_frames(n):
    """1080p UYVY frames of a seeded picture panned 2 samples right and 1
    down a frame: chip_smoke.py's sequence."""
    from chip_smoke import h264_sequence

    return h264_sequence(n)


def test_h264_intra_1080p_on_card_equals_cpu(cuda):
    from ultragrid_tpu_torch.ops.h264_device import Intra16EncoderDevice

    f = _h264_frames(1)[0]
    for qp in (20, 34):
        card = Intra16EncoderDevice(1920, 1080, qp=qp, device=cuda).encode_uyvy(torch.as_tensor(f).to(cuda))
        assert card == Intra16EncoderDevice(1920, 1080, qp=qp, device="cpu").encode_uyvy(f)


@pytest.mark.parametrize("kw", [{"search": 8}, {"search": 4, "subpel": "quarter"}], ids=["half-s8", "quarter-s4"])
def test_h264_p_1080p_on_card_equals_cpu_and_decodes(cuda, kw):
    """I P P I: byte-equal access units, the reference picture stays on the
    card, and the C decoder reads every frame back to it."""
    from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice
    from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder

    card = InterEncoderDevice(1920, 1080, qp=26, gop=3, device=cuda, **kw)
    cpu = InterEncoderDevice(1920, 1080, qp=26, gop=3, device="cpu", **kw)
    dec = FastStreamDecoder()
    for i, f in enumerate(_h264_frames(4)):
        au = card.encode_uyvy(torch.as_tensor(f).to(cuda))
        assert au == cpu.encode_uyvy(f), f"frame {i}"
        assert all(p.is_cuda for p in card.ref)
        for got, ref in zip(dec.decode_au(au), card.ref):
            assert np.array_equal(got, ref.cpu().numpy()[:got.shape[0], :got.shape[1]]), f"frame {i}"


def test_h264_p_ties_on_card_give_zero_vectors(cuda):
    """Flat content: every candidate of every search stage ties, the first
    (the zero vector) wins on the card as in the reference, and every
    macroblock is P_Skip."""
    from ultragrid_tpu_torch.ops import h264
    from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice, uyvy_to_planes

    flat = torch.full((1080, 3840), 128, dtype=torch.uint8, device=cuda)
    flat[:, 1::2] = 90
    enc = InterEncoderDevice(1920, 1080, qp=26, search=8, device=cuda)
    enc.ref = uyvy_to_planes(flat, 1920, 1080)
    enc._frame_idx = enc._frame_num = 1
    for frame_num in (1, 2):
        bw = h264.BitWriter()
        h264._p_slice_header(bw, 0, frame_num)
        bw.ue(120 * 68)
        bw.rbsp_trailing()
        assert enc.encode_uyvy(flat) == h264.nal(3, 1, bw.rbsp())


# ---- the wavelet and intra codecs (PyTorch device stages, host entropy) ----

CODEC_SPECS = ["jpegxs", "jpegxs:100", "cineform", "cineform:100", "openapv", "openapv:0", "j2k:90"]


@pytest.mark.parametrize("spec", CODEC_SPECS)
def test_codec_1080p_on_card_equals_cpu(cuda, spec):
    """The stream of the module on the card is the CPU module's, byte for
    byte (integer DWTs; the APV transform's fused multiply-add order is the
    same on both), and its decode on the card is the CPU's and stays on the
    card; the lossless specs give the input back."""
    from ultragrid_tpu_torch.modules.video_compress import compress_init
    from ultragrid_tpu_torch.modules.video_decompress import decompress_init

    src = content(1920, 1080, Codec.UYVY, 31)
    desc = VideoDesc(1920, 1080, Codec.UYVY, 60.0)
    card = compress_init(spec, device=cuda).compress(VideoFrame(desc, [torch.as_tensor(src).to(cuda)]))
    cpu = compress_init(spec, device="cpu").compress(VideoFrame(desc, [torch.as_tensor(src)]))
    assert bytes(np.asarray(card.data)) == bytes(np.asarray(cpu.data))
    dec_card, out = decompress_init(card.desc.color_spec, [Codec.UYVY, Codec.RGB], device=cuda)
    dec_cpu, _ = decompress_init(card.desc.color_spec, [Codec.UYVY, Codec.RGB], device="cpu")
    got, want = dec_card.decompress(card, out).data, dec_cpu.decompress(cpu, out).data
    assert got.is_cuda and torch.equal(got.cpu(), want)
    if spec in ("jpegxs:100", "cineform:100"):
        assert np.array_equal(got.cpu().numpy(), src)


# ---- audio in the live session, and the session's record and replay ----

@pytest.mark.parametrize("spec", ["rs:16:24", "rs:200:240"])
@pytest.mark.parametrize("nbytes", [3840, 1600])
def test_audio_rs_parity_on_card_equals_cpu(cuda, spec, nbytes):
    """``-f A:rs:k:n``: each channel's RS parity from the Tx on the card (its
    default device) equals the CPU's, at the audio thread's chunk (1/25 s of
    48 kHz 16-bit) and at ``-I``'s chunk of one 60 fps frame."""
    from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
    from ultragrid_tpu_torch.net.transmit import Tx

    class Recorder:
        def __init__(self):
            self.packets = []

        def send_data_hdr(self, ts, pt, m, payload_hdr, data):
            self.packets.append((pt, m, payload_hdr + data))

    rng = np.random.default_rng(8)
    frame = AudioFrame(AudioDesc(), [rng.integers(0, 256, nbytes, dtype=np.uint8) for _ in range(2)])
    card, cpu = Recorder(), Recorder()
    tx = Tx()
    assert tx.device.type == "cuda"
    tx.send_audio(card, frame, "PCM", fec_spec=spec)
    Tx(device="cpu").send_audio(cpu, frame, "PCM", fec_spec=spec)
    assert card.packets == cpu.packets


def test_import_capture_on_card(cuda, tmp_path):
    """``-E`` on the card, then ``ImportCapture`` (its default device is the
    card): every frame it hands out is on the card and equal to the recorded
    file, and its embedded audio is the recorded wav."""
    import wave

    from ultragrid_tpu_torch.pipeline.sender import VideoSender
    from ultragrid_tpu_torch.utils.export import ImportCapture

    from tests.test_torch_net import free_port_pair

    rec = str(tmp_path / "rec")
    sender = VideoSender("testcard:s=1920x1080:f=60:c=UYVY", "127.0.0.1", tx_port=free_port_pair(), frame_limit=8,
                         audio_capture="testcard", record=rec)
    assert sender.run() == 8
    cap = ImportCapture(rec)
    assert cap.device.type == "cuda" and cap.frame_count == 8
    with wave.open(f"{rec}/sound.wav", "rb") as wf:
        wav = np.frombuffer(wf.readframes(wf.getnframes()), np.uint8)
    audio = []
    for i in range(8):
        frame, a = cap.grab()
        assert frame.data.is_cuda
        assert np.array_equal(frame.data.cpu().numpy().reshape(-1), np.fromfile(f"{rec}/{i + 1:08d}.yuv", np.uint8))
        assert any(torch.equal(frame.data, r) for r in sender.capture.frames)
        if a is not None:
            audio.append(a.to_interleaved())
    cap.done()
    got = np.concatenate(audio)
    assert got.size > 0 and np.array_equal(got, wav[:got.size])


def test_standards_mode_jpeg_round_trip_on_card(cuda):
    """K1 on the card -> RFC 2435 packets (``Tx(rfc2435=True)``, PT 26) ->
    ``VideoRxState`` -> ``JpegDecompress`` on the card, at 1080p, against
    the CPU's encode of the same frame and its decode of the rebuilt file."""
    from ultragrid_tpu_torch.net import transmit, video_rx
    from ultragrid_tpu_torch.net.pbuf import PbufNode
    from ultragrid_tpu_torch.net.rtp import RtpPacket

    f = content(1920, 1080, Codec.UYVY, 51)
    jpeg_cuda.LAUNCHES.reset()
    card_file = JpegEncoder(1920, 1080).encode(torch.as_tensor(f).to(cuda))
    assert jpeg_cuda.LAUNCHES.count >= 1
    assert np.array_equal(card_file, JpegEncoder(1920, 1080).encode(f, device="cpu"))
    sent = []

    class Recorder:
        def send_data_hdr(self, ts, pt, m, payload_hdr, data):
            sent.append((pt, m, bytes(payload_hdr) + bytes(data)))

    desc = VideoDesc(1920, 1080, Codec.JPEG, 60.0)
    n = transmit.Tx(rfc2435=True, device=cuda).send_video(Recorder(), VideoFrame(desc, [card_file], timestamp=2.0))
    assert n == len(sent) > 1 and {pt for pt, _, _ in sent} == {26}
    node = PbufNode(ts=180000, arrival=0.0, playout_delay=0.0)
    for i, (pt, m, payload) in enumerate(sent):
        node.packets.append(RtpPacket(pt, i, 180000, 1, m, payload, 0.0))
    frame = video_rx.VideoRxState(device=cuda).reassemble(node)
    got = JpegDecompress(device=cuda).decompress(frame, Codec.UYVY).data
    want = JpegDecompress(device="cpu").decompress(frame, Codec.UYVY).data
    assert got.is_cuda
    diff = (got.cpu().to(torch.int16) - want.to(torch.int16)).abs()
    assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 0.001 * want.numel()
    original = JpegDecompress(device=cuda).decompress(VideoFrame(desc, [card_file]), Codec.UYVY).data
    assert torch.equal(got, original)


def test_thumbnailgen_on_card_equals_cpu(cuda, tmp_path):
    """``write_thumbnail`` at the preview's 960x540: K1's RGB 4:4:4
    template on the card, the file byte-equal to the CPU's."""
    from ultragrid_tpu_torch.tools.thumbnailgen import write_thumbnail

    rgb = content(960, 540, Codec.RGB, 52).tobytes()
    jpeg_cuda.LAUNCHES.reset()
    write_thumbnail(960, 540, rgb, str(tmp_path / "card.jpg"), device=cuda)
    assert jpeg_cuda.LAUNCHES.count >= 1
    write_thumbnail(960, 540, rgb, str(tmp_path / "cpu.jpg"), device="cpu")
    assert (tmp_path / "card.jpg").read_bytes() == (tmp_path / "cpu.jpg").read_bytes()


# ---- the multi-device path: four row bands on one card ----


def _par_bands(cuda, w, h, seed):
    from ultragrid_tpu_torch.parallel import make_mesh, shard_frame_rows

    mesh = make_mesh(devices=[cuda] * 4)
    f = content(w, h, Codec.UYVY, seed)
    return mesh, f, shard_frame_rows(torch.as_tensor(f).to(cuda), mesh)


def test_sharded_sender_step_8k_on_card(cuda):
    """The sender step at 8K UYVY as 4 bands of 7680x1080 with LDGM
    256:26:5: K1 and K2 launch 4 times a step; each band's slots and parity
    equal a single-band encode plus K2's plain version, and the CPU port's."""
    from ultragrid_tpu_torch.parallel import make_mesh
    from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedSenderStep

    mesh, f, bands = _par_bands(cuda, 7680, 4320, 60)
    step = ShardedSenderStep(7680, 4320, mesh, k=256, m=26, c=5)
    jpeg_cuda.LAUNCHES.reset()
    fec.LAUNCHES.reset()
    outs = step(bands)
    assert (jpeg_cuda.LAUNCHES.count, fec.LAUNCHES.count) == (4, 4)
    single = JpegEncoder(7680, 1080, restart_interval=step.base.local.restart_interval)
    cpu = ShardedSenderStep(7680, 4320, make_mesh(4, device="cpu"), k=256, m=26, c=5)(f)
    for band, o, co in zip(bands, outs, cpu):
        want = single._encode(band)
        assert all(torch.equal(a, b) for a, b in zip(o[:6], want[:6])) and not bool(o[7])
        assert torch.equal(o[6], step.parity.plain(*want[:6]).view(torch.uint8).reshape(26, step.ps))
        assert all(a.is_cuda and torch.equal(a.cpu(), b) for a, b in zip(o[:7], co[:7]))


def test_sharded_receiver_step_on_card(cuda):
    """One data symbol erased per band: the peel on the card brings every
    band back; the frame is within the decoder's tolerance of the CPU plain
    path and of the unsharded decode."""
    from ultragrid_tpu_torch.parallel import make_mesh
    from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedReceiverStep, ShardedSenderStep, band_symbols

    mesh, f, bands = _par_bands(cuda, 1920, 1088, 61)
    step = ShardedSenderStep(1920, 1088, mesh, k=256, m=26, c=5)
    outs = step(bands)
    sym = np.stack([band_symbols(o, step.row_counts, step.ps, 256) for o in outs])
    present = np.ones(sym.shape[:2], bool)
    present[:, 5] = False
    sym[:, 5] = 0
    rx = ShardedReceiverStep(1920, 1088, mesh, k=256, m=26, c=5, wwords=step.base.local.wwords)
    fec.LAUNCHES.reset()
    got, ok = rx(sym, present)
    assert ok.all() and all(b.is_cuda for b in got) and fec.LAUNCHES.count == sum(rx.rounds) >= 4
    want, _ = ShardedReceiverStep(1920, 1088, make_mesh(4, device="cpu"), k=256, m=26, c=5,
                                  wwords=step.base.local.wwords)(sym, present)
    from ultragrid_tpu_torch.ops.jpeg import JpegDecoder

    whole = JpegDecoder(cuda).decode_to_uyvy(bytes(step.base.encode(bands)))[0]
    for ref in (torch.cat(want), whole):
        diff = (torch.cat(got).cpu().to(torch.int16) - ref.cpu().to(torch.int16)).abs()
        assert int(diff.max()) <= 1 and int((diff > 0).sum()) <= 0.001 * diff.numel()


def test_sharded_deinterlace_h264_and_dryrun_on_card(cuda):
    """The halo deinterlace at 8K equals ops/postprocess on the whole
    frame; sharded H.264 at 1080p x 4 equals the CPU port's access unit;
    the dry run's asserts hold on four bands of the card."""
    from ultragrid_tpu_torch.ops import postprocess
    from ultragrid_tpu_torch.parallel import make_mesh
    from ultragrid_tpu_torch.parallel.dryrun import dryrun_multichip
    from ultragrid_tpu_torch.parallel.sharded_h264 import ShardedH264Encoder
    from ultragrid_tpu_torch.parallel.sharded_post import sharded_deinterlace

    mesh, f, _ = _par_bands(cuda, 7680, 4320, 62)
    frame = torch.as_tensor(f).to(cuda)
    for kind, fn in (("blend", postprocess.deinterlace_blend), ("linear", postprocess.deinterlace_linear)):
        assert torch.equal(torch.cat(sharded_deinterlace(frame, Codec.UYVY, mesh, kind=kind)), fn(frame, Codec.UYVY))
    h = content(1920, 1080, Codec.UYVY, 63)
    au = ShardedH264Encoder(1920, 1080, mesh).encode(torch.as_tensor(h).to(cuda))
    assert au == ShardedH264Encoder(1920, 1080, make_mesh(4, device="cpu")).encode(h)
    dryrun_multichip(4, devices=[cuda] * 4)
