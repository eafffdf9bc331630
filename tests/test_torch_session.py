"""The port's session layer against the JAX package's, on the CPU.

Repairs P1 (``jpeg`` rate control) and P2 (the JPEG geometries without a
mega matrix), ``compress_init`` and ``CompressDriver`` with its runtime swap,
``decompress_init``, ``LoopbackRxTx`` and the CLI, each driven the same way
through the reference and through the port (``device="cpu"``), the inputs
made from a seed with numpy.  Tolerance: equal quality sequences, byte-equal
files and frames.

P2: the reference's per-plane front end raises for every geometry it serves
(its UYVY chroma is half as wide as 4:4:4 blocks need, its RGB chroma twice
as wide as 4:2:2 blocks need).  The port closes the gap by repeating each
UYVY chroma byte and averaging each RGB chroma pair; the files here are held
to the reference's own stages (``_planes_from_input``, ``_blockify_plane``,
the per-plane products, ``_encode_component_symbols``, ``_pack_block_slots``,
``assemble``) with that resampling put between them, in one jit.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu import cli as ref_cli  # noqa: E402
from ultragrid_tpu.modules import extra_displays as ref_extra  # noqa: E402
from ultragrid_tpu.modules import messaging as ref_msg  # noqa: E402
from ultragrid_tpu.modules import video_compress as ref_vc  # noqa: E402
from ultragrid_tpu.modules import video_decompress as ref_vd  # noqa: E402
from ultragrid_tpu.ops import jpeg as ref_jpeg  # noqa: E402
from ultragrid_tpu.pipeline.loopback import LoopbackRxTx as RefLoopback  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.modules import extra_displays  # noqa: E402
from ultragrid_tpu_torch.modules.lavc import lavc_available  # noqa: E402
from ultragrid_tpu_torch.modules.messaging import Module, MsgChangeCompress, send_message  # noqa: E402
from ultragrid_tpu_torch.modules.video_compress import CompressDriver, JpegCompress, compress_init  # noqa: E402
from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress, decompress_init  # noqa: E402
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder  # noqa: E402
from ultragrid_tpu_torch.pipeline.loopback import LoopbackRxTx  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import params  # noqa: E402

from tests.test_torch_net import free_port_pair  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_params():
    yield
    params.reset_params()


def _frames(n, w=128, h=64, seed=0):
    """UYVY frames whose detail varies, so a rate controller moves."""
    rng = np.random.default_rng(seed)
    ramp = np.arange(2 * w)[None, :] // 2 + 48
    return [np.clip(ramp + rng.normal(0, rng.uniform(6, 18), (h, 2 * w)), 0, 255).astype(np.uint8)
            for _ in range(n)]


def _host(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


# ---------------------------------------------------------------------------
# P1: jpeg rate control
# ---------------------------------------------------------------------------


def test_jpeg_rate_control_equals_reference():
    """``jpeg:80:rate=`` over 32 seeded frames: the same quality per frame
    and byte-equal files."""
    w, h = 128, 64
    ref = ref_vc.JpegCompress("80:rate=840k")
    port = compress_init("jpeg:80:rate=840k", device="cpu")
    assert isinstance(port, JpegCompress) and port._rate_bps == ref._rate_bps == 840_000
    qs_ref, qs_port = [], []
    for f in _frames(32, w, h):
        r = ref.compress(RefFrame(RefDesc(w, h, RefCodec.UYVY, 30.0), [f]))
        qs_ref.append(ref._rc.value)
        p = port.compress(VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [f]))
        qs_port.append(port._rc.value)
        assert np.array_equal(np.asarray(r.data), p.data)
    assert qs_port == qs_ref
    assert len(set(qs_ref)) >= 2  # the controller moved


def test_fixed_bitrate_reaches_jpeg_rate_control():
    """A fixed ``-l`` reaches ``set_target_bitrate``; an explicit ``rate=``
    wins over it (reference sender.py:127-133)."""
    for spec, want in (("jpeg:80", 3_000_000), ("jpeg:80:rate=1M", 1_000_000)):
        s = VideoSender("testcard:s=64x32:f=1000:c=UYVY", "127.0.0.1", compress_spec=spec,
                        tx_port=9, bitrate=3_000_000, device="cpu")
        try:
            assert s.compress.impl._rate_bps == want
        finally:
            s.compress.stop()
            s.session.close()
            s.capture.done()


# ---------------------------------------------------------------------------
# P2: the per-plane JPEG geometries
# ---------------------------------------------------------------------------


def _ref_per_plane_file(w, h, codec, sub, frame, quality=80, restart_interval=None):
    """The file of the reference's per-plane stages, with the chroma
    resampling they lack between ``_planes_from_input`` and the blocks."""
    e = ref_jpeg.JpegEncoder(w, h, in_codec=RefCodec(int(codec)), quality=quality,
                             restart_interval=restart_interval, subsampling=sub)
    assert e._mega is None
    ac_l, ac_c = ref_jpeg.pack_tables(*e._ac_l), ref_jpeg.pack_tables(*e._ac_c)

    def fn(frame):
        (yp, up, vp), shifted = e._planes_from_input(frame)
        if sub == "444":
            up, vp = jnp.repeat(up, 2, axis=1), jnp.repeat(vp, 2, axis=1)
            yb = ref_jpeg._blockify_plane(yp, 8, 8)
        else:
            up, vp = (up[:, 0::2] + up[:, 1::2]) * 0.5, (vp[:, 0::2] + vp[:, 1::2]) * 0.5
            yb = yp.reshape(e.nmcuy, 8, e.nmcux, 2, 8).transpose(0, 2, 3, 1, 4).reshape(e.nmcu * 2, 64)
        ub, vb = ref_jpeg._blockify_plane(up, 8, 8), ref_jpeg._blockify_plane(vp, 8, 8)
        # reference ops/jpeg.py:664-681
        m_zz = jnp.asarray(ref_jpeg.dct_matrix_64())[jnp.asarray(ref_jpeg.ZIGZAG), :]
        qy = jnp.asarray(e.qtab_luma[ref_jpeg.ZIGZAG]).astype(jnp.float32)
        qc = jnp.asarray(e.qtab_chroma[ref_jpeg.ZIGZAG]).astype(jnp.float32)
        my, mc = (m_zz / qy[:, None]).T, (m_zz / qc[:, None]).T
        if shifted:
            cy = cc = jnp.zeros((64,), jnp.float32)
        else:
            cy, cc = 128.0 * my.sum(axis=0), 128.0 * mc.sum(axis=0)

        def mk(blocks, m, c):
            f = jnp.dot(blocks.astype(jnp.float32), m, preferred_element_type=jnp.float32)
            return jnp.round(f - c[None, :]).astype(jnp.int32)

        # reference ops/jpeg.py:683-705
        seg = (jnp.arange(e.nmcu) % e.restart_interval) == 0
        yseg = jnp.stack([seg, jnp.zeros_like(seg)], axis=1).reshape(-1) if sub == "422" else seg
        out = []
        for q, dc, ac, tabs, s in ((mk(yb, my, cy), e._dc_l, e._ac_l, ac_l, yseg),
                                   (mk(ub, mc, cc), e._dc_c, e._ac_c, ac_c, seg),
                                   (mk(vb, mc, cc), e._dc_c, e._ac_c, ac_c, seg)):
            eob = (int(ac[0][0]), int(ac[1][0]))
            zrl = (int(ac[0][0xF0]), int(ac[1][0xF0]))
            sym = ref_jpeg._encode_component_symbols(
                q, jnp.asarray(dc[0]), jnp.asarray(dc[1]), tuple(jnp.asarray(t) for t in tabs),
                *eob, *zrl, s)
            out.extend(ref_jpeg._pack_block_slots(*sym, e.wwords)[:2])
        return out

    parts = [np.asarray(p) for p in jax.jit(fn)(jnp.asarray(frame))]
    body = e.assemble(*parts)
    return np.concatenate([np.frombuffer(e._header, np.uint8), body, np.frombuffer(b"\xff\xd9", np.uint8)])


_P2 = [(Codec.UYVY, "444", 2), (Codec.YUYV, "444", 2), (Codec.RGB, "422", 3), (Codec.RGBA, "422", 4)]


@pytest.mark.parametrize("codec,sub,bpp", _P2, ids=[f"{c.name}-{s}" for c, s, _ in _P2])
@pytest.mark.parametrize("w,h", [(128, 64), (64, 128)])
def test_per_plane_files_equal_reference_stages(codec, sub, bpp, w, h):
    frame = np.random.default_rng(w + bpp).integers(0, 256, (h, w * bpp), dtype=np.uint8)
    ref = _ref_per_plane_file(w, h, codec, sub, frame)
    enc = JpegEncoder(w, h, in_codec=codec, quality=80, subsampling=sub)
    assert enc.per_plane
    port = enc.encode(torch.as_tensor(frame))
    assert np.array_equal(port, ref)


@pytest.mark.parametrize("quality", [10, 50, 95, 100])
def test_per_plane_level_shift_constants_equal_reference(quality):
    """The folded -128 level shift of YCbCr planes: XLA's column sums."""
    e = ref_jpeg.JpegEncoder(64, 64, in_codec=RefCodec.UYVY, quality=quality, subsampling="444")

    def consts():
        m_zz = jnp.asarray(ref_jpeg.dct_matrix_64())[jnp.asarray(ref_jpeg.ZIGZAG), :]
        qy = jnp.asarray(e.qtab_luma[ref_jpeg.ZIGZAG]).astype(jnp.float32)
        qc = jnp.asarray(e.qtab_chroma[ref_jpeg.ZIGZAG]).astype(jnp.float32)
        my, mc = (m_zz / qy[:, None]).T, (m_zz / qc[:, None]).T
        return my, mc, 128.0 * my.sum(axis=0), 128.0 * mc.sum(axis=0)

    my, mc, cy, cc = (np.asarray(a) for a in jax.jit(consts)())
    st = JpegEncoder(64, 64, in_codec=Codec.UYVY, quality=quality, subsampling="444").state
    assert np.array_equal(st["W"], np.concatenate([my, mc], axis=1))
    assert np.array_equal(st["const"], np.concatenate([cy, cc]))


def test_per_plane_through_jpeg_compress_and_decompress():
    """``jpeg:80:0:444`` on a UYVY frame: the port's module encodes it and
    the port's decoder reads it back to 4:2:2 (chroma repeated, then taken
    every other sample: the input's chroma within the codec's error)."""
    w, h = 64, 64
    frame = _frames(1, w, h, seed=3)[0]
    out = JpegCompress("80:0:444", device="cpu").compress(VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [frame]))
    back = JpegDecompress(device="cpu").decompress(out, Codec.UYVY)
    assert tuple(back.data.shape) == (h, 2 * w)
    err = np.abs(back.data.numpy().astype(int) - frame.astype(int))
    assert err.mean() < 8


def test_reference_per_plane_path_raises():
    """Why the comparison composes stages: the reference's own encode of a
    per-plane geometry fails on its chroma's block count."""
    e = ref_jpeg.JpegEncoder(64, 64, in_codec=RefCodec.UYVY, quality=80, subsampling="444")
    with pytest.raises(ValueError):
        e.encode(np.zeros((64, 128), np.uint8))


# ---------------------------------------------------------------------------
# compress_init, CompressDriver, decompress_init, LoopbackRxTx
# ---------------------------------------------------------------------------


def _drive(driver, frames, messages, send):
    """Push frames through a compress driver; messages[i] is sent before
    frame i.  Returns the outputs and the responses."""
    outs, resp = [], []
    for i, f in enumerate(frames):
        if i in messages:
            resp.append(send(messages[i]).code)
        driver.enqueue(f)
        outs.append(driver.pop(timeout=60))
    driver.stop()
    return outs, resp


def test_compress_driver_runtime_swap_equals_reference():
    # tiles of 64 MCUs or more: below that XLA's CPU dot sums in another order
    w, h = 256, 64
    frames = _frames(4, w, h, seed=5)
    tiled = [frames[3][:, :w], frames[3][:, w:]]
    messages = {1: "JPEG:60", 2: "nosuch", 3: "jpeg:90"}

    root = ref_msg.Module("root")
    ref_frames = [RefFrame(RefDesc(w, h, RefCodec.UYVY, 30.0), [f]) for f in frames[:3]]
    ref_frames.append(RefFrame(RefDesc(w // 2, h, RefCodec.UYVY, 30.0, tile_count=2), tiled))
    ref_out, ref_resp = _drive(ref_vc.CompressDriver("none", root), ref_frames, messages,
                               lambda m: ref_msg.send_message(root, "compress", ref_msg.MsgChangeCompress(m)))
    root = Module("root")
    port_frames = [VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [f]) for f in frames[:3]]
    port_frames.append(VideoFrame(VideoDesc(w // 2, h, Codec.UYVY, 30.0, tile_count=2), tiled))
    port_out, port_resp = _drive(CompressDriver("none", root, device="cpu"), port_frames, messages,
                                 lambda m: send_message(root, "compress", MsgChangeCompress(m)))
    assert port_resp == ref_resp == [200, 500, 200]
    for r, p in zip(ref_out, port_out):
        assert int(p.desc.color_spec) == int(r.desc.color_spec) and p.desc.tile_count == r.desc.tile_count
        for rt_, pt_ in zip(r.tiles, p.tiles):
            assert np.array_equal(np.asarray(rt_), _host(pt_))
    assert port_out[0].desc.color_spec == Codec.UYVY and port_out[3].desc.tile_count == 2


def test_compress_init_refuses_unknown_names():
    with pytest.raises(ValueError, match="unknown compression 'nosuchcodec'"):
        compress_init("nosuchcodec:codec=H.265", device="cpu")
    if lavc_available():
        assert type(compress_init("libavcodec:codec=H.265", device="cpu")).__name__ == "LavcCompress"
    else:
        with pytest.raises(ValueError, match="libavcodec"):
            compress_init("libavcodec:codec=H.265", device="cpu")
    assert isinstance(compress_init("GPUJPEG:70", device="cpu"), JpegCompress)
    assert type(compress_init("h264:qp=26", device="cpu")).__name__ == "H264Compress"


def test_decompress_init_selects_and_refuses_by_name():
    dec, out = decompress_init(Codec.JPEG, [Codec.RGB, Codec.UYVY], device="cpu")
    assert isinstance(dec, JpegDecompress) and out == Codec.RGB
    assert decompress_init(Codec.DXT1, [Codec.UYVY], device="cpu") == (None, None)
    dec, out = decompress_init(Codec.H264, [Codec.UYVY], device="cpu")
    assert type(dec).__name__ == "OwnH264Decompress" and out == Codec.UYVY
    for codec, out_codec, name in ((Codec.JPEG_XS, Codec.UYVY, "JpegXsDecompress"),
                                   (Codec.CFHD, Codec.UYVY, "CineformDecompress"),
                                   (Codec.APV, Codec.UYVY, "ApvDecompress"), (Codec.J2KR, Codec.RGB, "J2kDecompress"),
                                   (Codec.J2K, Codec.RGB, "J2kDecompress")):
        dec, out = decompress_init(codec, [Codec.UYVY, Codec.RGB], device="cpu")
        assert type(dec).__name__ == name and out == out_codec
    # libavcodec's decoder last, for what no own decoder reads (ref
    # decompress_init); refused by name where libavcodec is absent
    if lavc_available():
        dec, out = decompress_init(Codec.VP9, [Codec.UYVY], device="cpu")
        assert type(dec).__name__ == "LavcDecompress" and out == Codec.UYVY
        ref_dec, ref_out = ref_vd.decompress_init(RefCodec.VP9, [RefCodec.UYVY])
        assert type(ref_dec).__name__ == "LavcDecompress" and int(ref_out) == int(out)
    else:
        with pytest.raises(NotImplementedError, match="libavcodec"):
            decompress_init(Codec.VP9, [Codec.UYVY], device="cpu")


@pytest.mark.parametrize("compress", ["none", "jpeg:80", "dxt"])
def test_loopback_equals_reference(compress):
    spec = "testcard:s=128x64:f=1000:c=UYVY"
    got, ref_got = [], []
    extra_displays.register_pipe_delegate("lb_port", got.append)
    ref_extra.register_pipe_delegate("lb_ref", ref_got.append)
    n_ref = RefLoopback(spec, "pipe:lb_ref", compress_spec=compress, frame_limit=3).run()
    n = LoopbackRxTx(spec, "pipe:lb_port", compress_spec=compress, frame_limit=3, device="cpu").run()
    assert n == n_ref == 3
    frames = [f for f in got if f is not None]
    ref_frames = [f for f in ref_got if f is not None]
    assert len(frames) == len(ref_frames) == 3
    for p, r in zip(frames, ref_frames):
        assert int(p.desc.color_spec) == int(r.desc.color_spec)
        assert np.array_equal(_host(p.data), np.asarray(r.data))


def test_loopback_bounds_its_queues_by_buff_max_len():
    """The frames queued between the loopback's halves are bounded by the
    reference's ``BUFF_MAX_LEN`` (ref: loopback.c:62)."""
    from ultragrid_tpu.pipeline import loopback as ref_loopback_mod
    from ultragrid_tpu_torch.pipeline import loopback as loopback_mod

    assert loopback_mod.BUFF_MAX_LEN == ref_loopback_mod.BUFF_MAX_LEN == 2
    lb = LoopbackRxTx("testcard:s=64x32:f=1000:c=UYVY", "dummy", frame_limit=2, device="cpu")
    assert lb.compress.in_queue.maxsize == lb.compress.out_queue.maxsize == loopback_mod.BUFF_MAX_LEN
    assert lb.run() == 2


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

_ARGV = [
    ["-t", "testcard:s=64x32", "-c", "jpeg:80", "-f", "ldgm:256:26:5", "127.0.0.1"],
    ["-d", "dummy", "-P", "6004", "-m", "9000", "--param", "vrx-fast=off", "--frames", "7"],
    ["-t", "testcard", "-c", "jpeg:rate=10M", "-f", "V:rs:200:240", "-l", "50M", "-T", "8", "-6", "::1"],
    ["-t", "testcard", "-d", "dummy", "-x", "loopback", "-F", "mirror", "-p", "scale:32x16", "-M", "3D"],
    ["-t", "testcard", "-n", "0", "--start-paused", "--mcast-if", "10.0.0.1", "-4", "239.1.1.1"],
]


@pytest.mark.parametrize("argv", _ARGV, ids=range(len(_ARGV)))
def test_cli_parses_reference_argv(argv):
    ours = vars(cli.build_parser().parse_args(argv))
    ref = vars(ref_cli.build_parser().parse_args(argv))
    port_only = {"device"}
    for key, val in ours.items():
        if key in port_only:
            continue
        if key in ref and val is not None:
            assert val == ref[key], key
    assert ours["device"] == "cuda"
    assert cli.refusal(cli.build_parser().parse_args(argv)) == ""


_REFUSED = [
    (["-t", "testcard", "-A", "Opus", "h"], ""),
    (["-t", "testcard", "-N", "h"], ""),
    (["-t", "testcard", "-x", "mpegts", "h"], ""),
    (["-d", "dummy", "--window-title", "x"], ""),
    (["-d", "dummy", "--param", "h264-decoder=lavc"], ""),
    (["-t", "testcard", "-x", "sage", "h"], "SAGE SDK"),
    (["-t", "testcard", "-x", "omt", "h"], "Open Media Transport SDK"),
]


@pytest.mark.parametrize("argv,name", _REFUSED, ids=[a[-2] if len(a) > 2 else a[0] for a, _ in _REFUSED])
def test_cli_refuses_options_outside_the_port_by_name(argv, name, capsys):
    """The libavcodec audio codecs, -N, mpegts, --window-title and the lavc
    H.264 decoder are the port's now: parsed as the reference parses them and
    accepted.  Only sage and omt, whose SDKs are absent, are refused by
    name, as the reference refuses them (ref cli.py:319-325)."""
    args = cli.build_parser().parse_args(argv)
    if name:
        assert cli.main(argv) == 1
        assert name in capsys.readouterr().err
        return
    assert cli.refusal(args) == ""
    ref = vars(ref_cli.build_parser().parse_args(argv))
    for key, val in vars(args).items():
        if key in ref and val is not None:
            assert val == ref[key], key


# options refused until their modules landed (audio, -E and -I; standards
# mode, RTSP, iHDTV, duplex and echo cancellation; -e): accepted now, and parsed
# as the reference parses them
_ACCEPTED = [
    ["-t", "testcard", "-s", "testcard", "h"],
    ["-d", "dummy", "-r", "dummy"],
    ["-t", "testcard", "-f", "A:rs:200:240", "h"],
    ["-t", "testcard", "-E", "dir", "h"],
    ["-I", "dir", "h"],
    ["-d", "dummy", "--audio-delay", "20"],
    ["-t", "testcard", "--rtsp"],
    ["-t", "testcard", "--rtp-standard", "h"],
    ["-t", "testcard", "-x", "ihdtv", "h"],
    ["-t", "testcard", "-d", "dummy", "h"],
    ["-t", "testcard", "-s", "testcard", "--echo-cancellation", "h"],
    ["-t", "testcard", "-e", "secret:cipher=cbc", "h"],
]


@pytest.mark.parametrize("argv", _ACCEPTED, ids=[a[-2] if len(a) > 2 else a[0] for a in _ACCEPTED])
def test_cli_accepts_the_ported_audio_and_record_options(argv):
    args = cli.build_parser().parse_args(argv)
    assert cli.refusal(args) == ""
    ours, ref = vars(args), vars(ref_cli.build_parser().parse_args(argv))
    for key, val in ours.items():
        # None: an option the port refuses, unset (the reference's default may be False)
        if key != "device" and val is not None:
            assert val == ref[key], key
    for key in ("audio_capture", "audio_playback", "fec", "record", "playback", "audio_delay", "rtsp",
                "rtp_standard", "protocol", "echo_cancellation", "display"):
        assert ours[key] == ref[key], key


def test_cli_loopback_on_the_cpu_and_the_card_by_default(capsys):
    argv = ["-t", "testcard:s=64x32:f=1000:c=UYVY", "-d", "dummy", "-x", "loopback",
            "-c", "jpeg", "--frames", "2"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    assert "2 frames processed (loopback)" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            cli.main(argv)


def test_cli_receiver_and_sender_on_the_cpu():
    """``python -m ultragrid_tpu_torch`` as a receiver and a sender on
    127.0.0.1 in one process, ports from the OS."""
    port = free_port_pair()
    rc = {}
    rx = threading.Thread(target=lambda: rc.setdefault("rx", cli.main(
        ["-d", "dummy", "-P", str(port), "--frames", "2", "-n", "0", "--device", "cpu",
         "--param", "pbuf-delay=5"])), daemon=True)
    rx.start()
    for _ in range(3):
        rc["tx"] = cli.main(["-t", "testcard:s=64x32:f=60:c=UYVY:still=1", "-c", "jpeg", "-f", "ldgm:8:4:3",
                             "-P", str(port), "--frames", "10", "-n", "0", "--device", "cpu", "127.0.0.1"])
        rx.join(timeout=10)
        if not rx.is_alive():
            break
    assert not rx.is_alive(), "the receiver did not display 2 frames"
    assert rc == {"rx": 0, "tx": 0}
