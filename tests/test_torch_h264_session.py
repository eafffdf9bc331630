"""The port's H.264 session layer against the JAX package's, on the CPU.

``H264Compress`` (``-c h264``) in every mode -- i16 and inter on the
module's device (their default) and on the host, i4 and I_PCM, CABAC, the
in-loop deblocking signal, rate control and the ``-l`` hook -- gives the
reference module's access units and frame types; ``OwnH264Decompress``
(``h264_own``) gives the reference decoder's UYVY frames, through the C and
the Python decoder; ``decompress_init`` picks it; the CLI takes ``-c h264``
and ``--param h264-decoder=lavc``; ``--protocol loopback``
and a live session over 127.0.0.1 with LDGM and one packet dropped per frame
show the same frames as the reference, in both directions.  Inputs are made
from a seed with numpy.  Each reference graph is built once per module
(``tests/torch_h264_helpers.py``).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules import extra_displays as ref_extra  # noqa: E402
from ultragrid_tpu.modules.video_compress import H264Compress as RefH264Compress  # noqa: E402
from ultragrid_tpu.modules.video_decompress import OwnH264Decompress as RefOwnH264  # noqa: E402
from ultragrid_tpu.pipeline.loopback import LoopbackRxTx as RefLoopback  # noqa: E402
from ultragrid_tpu.pipeline.receiver import VideoReceiver as RefReceiver  # noqa: E402
from ultragrid_tpu.pipeline.sender import VideoSender as RefSender  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402
from ultragrid_tpu.utils import params as ref_params  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.modules import extra_displays  # noqa: E402
from ultragrid_tpu_torch.modules.lavc import lavc_available  # noqa: E402
from ultragrid_tpu_torch.modules.video_compress import H264Compress, compress_init  # noqa: E402
from ultragrid_tpu_torch.modules.video_decompress import OwnH264Decompress, decompress_init  # noqa: E402
from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice  # noqa: E402
from ultragrid_tpu_torch.ops.planar import i420_8_to_uyvy  # noqa: E402
from ultragrid_tpu_torch.pipeline.loopback import LoopbackRxTx  # noqa: E402
from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import params  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

from tests.test_torch_net import _lossy, free_port_pair  # noqa: E402
from tests.torch_h264_helpers import moving, shared_reference_graphs  # noqa: E402,F401

W, H = 64, 48


@pytest.fixture(autouse=True)
def _clean_params():
    yield
    params.reset_params()
    ref_params.reset_params()


def _host(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _compress_both(spec, frames, codec=Codec.UYVY, bitrate=None):
    """The port's module and the reference's on the same frames; where the
    spec names no ``accel``, the reference (host by default) is given the
    one the port chose (device for i16 and inter)."""
    port = H264Compress(spec, device="cpu")
    ref = RefH264Compress(spec if "accel=" in spec else f"{spec}:accel={port.accel}")
    if bitrate:
        port.set_target_bitrate(bitrate)
        ref.set_target_bitrate(bitrate)
    out = []
    for i, f in enumerate(frames):
        p = port.compress(VideoFrame(VideoDesc(W, H, codec, 30.0), [torch.as_tensor(f)], float(i)))
        r = ref.compress(RefFrame(RefDesc(W, H, RefCodec(int(codec)), 30.0), [f], float(i)))
        assert bytes(_host(p.data)) == bytes(np.asarray(r.data)), f"{spec}: frame {i}"
        assert p.desc.color_spec == Codec.H264 and p.timestamp == r.timestamp
        assert p.callbacks.get("frame_type") == r.callbacks.get("frame_type"), f"{spec}: frame {i}"
        assert port.qp == ref.qp
        out.append(bytes(_host(p.data)))
    port.done()
    return out


# rate control moves the QP, and every QP is a graph of its own for the
# reference's device encoders (15-20 s each here): the rate cases run the
# host encoders, whose controller is the same
_SPECS = ["qp=26", "accel=host:qp=26", "qp=30:deblock=1", "mode=i4:qp=28", "mode=pcm", "mode=inter:gop=3",
          "mode=inter:accel=host:gop=3:search=4", "mode=inter:accel=scalar:gop=3:search=4",
          "mode=inter:subpel=quarter:gop=3", "mode=inter:accel=host:subpel=quarter:gop=3", "accel=device",
          "accel=device:entropy=cabac", "mode=inter:accel=device:gop=3",
          "mode=inter:accel=device:gop=3:entropy=cabac", "mode=i4:entropy=cabac", "accel=host:rate=400k",
          "mode=inter:accel=host:gop=3:rate=150k"]


@pytest.mark.parametrize("spec", _SPECS)
def test_h264_compress_equals_reference(spec):
    aus = _compress_both(spec, moving(5, W, H))
    if "rate" in spec:
        assert len({len(a) for a in aus}) > 1


def test_h264_compress_converts_its_input_as_the_reference():
    rgb = [np.ascontiguousarray(np.repeat(f[:, 1::2, None], 3, axis=2).reshape(H, 3 * W)) for f in moving(2, W, H)]
    _compress_both("qp=26", rgb, codec=Codec.RGB)


def test_h264_compress_takes_the_senders_fixed_bitrate():
    _compress_both("mode=inter:accel=host:gop=2", moving(4, W, H), bitrate=120_000)


@pytest.mark.parametrize("spec,accel,cls", [
    ("", "device", "Intra16EncoderDevice"), ("qp=30", "device", "Intra16EncoderDevice"),
    ("mode=inter", "device", "InterEncoderDevice"), ("mode=inter:deblock=1", "device", "InterEncoderDevice"),
    ("accel=host", "host", "Intra16EncoderV"), ("mode=inter:accel=host", "host", "InterEncoderV"),
    ("deblock=1", "host", "Intra16EncoderV"), ("mode=i4", "host", "Intra4x4Encoder"),
    ("mode=pcm", "host", "PcmEncoder")])
def test_h264_compress_runs_i16_and_inter_on_its_device_by_default(spec, accel, cls):
    """``-c h264`` and ``-c h264:mode=inter`` encode on the module's device;
    the host copies run only where asked for or where the mode has no device
    encoder."""
    comp = compress_init(f"h264:{spec}" if spec else "h264", device="cpu")
    assert comp.accel == accel
    comp.compress(VideoFrame(VideoDesc(W, H, Codec.UYVY, 30.0), [torch.as_tensor(moving(1, W, H)[0])]))
    assert type(comp._enc).__name__ == cls
    if accel == "device":
        assert all(p.device.type == "cpu" for p in getattr(comp._enc, "ref", None) or ())
    comp.done()


def test_h264_compress_runs_on_the_module_device_and_owns_its_transcoder():
    comp = compress_init("h264:mode=inter:accel=device:entropy=cabac", device="cpu")
    assert isinstance(comp, H264Compress)
    comp.compress(VideoFrame(VideoDesc(W, H, Codec.UYVY, 30.0), [torch.as_tensor(moving(1, W, H)[0])]))
    assert comp._enc.ref[0].device.type == "cpu"
    handle = comp._transcoder._lh
    assert handle is not None and handle[1] != h264_transcode_shared_handle()
    comp.done()
    assert comp._transcoder is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            H264Compress("mode=inter").compress(VideoFrame(VideoDesc(W, H, Codec.UYVY, 30.0),
                                                           [torch.as_tensor(moving(1, W, H)[0])]))


def h264_transcode_shared_handle():
    from ultragrid_tpu_torch.ops.h264_transcode import _handle

    return _handle()[1]


# ---------------------------------------------------------------------------
# the own decoder
# ---------------------------------------------------------------------------


def _decode_both(aus, mode=None):
    if mode:
        params.set_commandline_param("h264-decoder", mode)
        ref_params.set_commandline_param("h264-decoder", mode)
    port, ref = OwnH264Decompress(device="cpu"), RefOwnH264()
    shown = []
    for i, au in enumerate(aus):
        p = port.decompress(VideoFrame(VideoDesc(W, H, Codec.H264, 30.0), [np.frombuffer(au, np.uint8)], i),
                            Codec.UYVY)
        r = ref.decompress(RefFrame(RefDesc(W, H, RefCodec.H264, 30.0), [np.frombuffer(au, np.uint8)], i),
                           RefCodec.UYVY)
        assert (p is None) == (r is None), f"AU {i}"
        if p is not None:
            assert isinstance(p.data, torch.Tensor) and p.data.device.type == "cpu"
            assert p.desc.color_spec == Codec.UYVY and (p.desc.width, p.desc.height) == (W, H)
            assert np.array_equal(_host(p.data), np.asarray(r.data)), f"AU {i}"
            shown.append(_host(p.data))
    return shown


@pytest.mark.parametrize("spec,mode", [("qp=26", None), ("mode=inter:accel=host:gop=3:search=4", None),
                                       ("mode=inter:gop=3", None),
                                       ("mode=inter:gop=3:entropy=cabac", None), ("mode=pcm", None),
                                       ("mode=inter:accel=host:gop=3:search=4", "python")],
                         ids=["i16", "inter-host", "inter-device", "inter-cabac", "pcm", "inter-python-decoder"])
def test_own_h264_decompress_equals_reference(spec, mode):
    comp = H264Compress(spec, device="cpu")
    aus = [bytes(_host(comp.compress(VideoFrame(VideoDesc(W, H, Codec.UYVY, 30.0), [torch.as_tensor(f)])).data))
           for f in moving(5, W, H)]
    comp.done()
    assert len(_decode_both(aus, mode)) == 5


def test_own_h264_decompress_returns_none_out_of_its_envelope():
    """A P frame with no IDR before it, and bytes that are no AU: None, as in
    the reference.  Where libavcodec is present the stream is handed to it
    for good (the reference's takeover), and it decodes the next IDR to the
    own decoder's picture; where it is absent the own decoder recovers at the
    next IDR.
    ``--param h264-decoder=lavc`` hands the stream over from its first
    frame: the port's takeover decodes that frame, the reference's loses it
    (its GOP cache is still empty when it hands over)."""
    comp = H264Compress("mode=inter:gop=10", device="cpu")
    aus = [bytes(_host(comp.compress(VideoFrame(VideoDesc(W, H, Codec.UYVY, 30.0), [torch.as_tensor(f)])).data))
           for f in moving(2, W, H)]
    garbage = b"\x00\x00\x00\x01\x65" + bytes(range(7, 200))

    def vf(au, pkg=None):
        desc = (RefDesc(W, H, RefCodec.H264, 30.0) if pkg else VideoDesc(W, H, Codec.H264, 30.0))
        return (RefFrame if pkg else VideoFrame)(desc, [np.frombuffer(au, np.uint8)])

    dec = OwnH264Decompress(device="cpu")
    for au in (aus[1], garbage):
        assert dec.decompress(vf(au), Codec.UYVY) is None
    got = dec.decompress(vf(aus[0]), Codec.UYVY)
    assert got is not None  # the stream recovers at the next IDR
    # through libavcodec (or the own decoder, where it is absent): the own
    # decoder's picture (the reference's lavc gives None here, F1)
    own = OwnH264Decompress(device="cpu").decompress(vf(aus[0]), Codec.UYVY)
    assert np.array_equal(_host(got.data), _host(own.data))
    ref = RefOwnH264()
    for au in (aus[1], garbage):
        assert ref.decompress(vf(au, "ref"), RefCodec.UYVY) is None
    params.set_commandline_param("h264-decoder", "lavc")
    ref_params.set_commandline_param("h264-decoder", "lavc")
    forced = OwnH264Decompress(device="cpu")
    if not lavc_available():
        assert forced.decompress(vf(aus[0]), Codec.UYVY) is None
        return
    ref = RefOwnH264()
    assert ref.decompress(vf(aus[0], "ref"), RefCodec.UYVY) is None
    first = forced.decompress(vf(aus[0]), Codec.UYVY)
    assert type(forced._delegate).__name__ == "LavcDecompress"
    assert np.array_equal(_host(first.data), _host(got.data))
    assert forced.decompress(vf(aus[1]), Codec.UYVY) is not None


def test_decompress_init_picks_the_own_h264_decoder():
    """The own decoder for H.264 to UYVY; for a display that asks RGB first,
    the reference's probe order (libavcodec last, the output candidates
    outermost) gives libavcodec's RGB where it is present, the own UYVY
    where it is absent."""
    dec, out = decompress_init(Codec.H264, [Codec.UYVY, Codec.RGB], device="cpu")
    assert isinstance(dec, OwnH264Decompress) and out == Codec.UYVY
    dec, out = decompress_init(Codec.H264, [Codec.RGB, Codec.UYVY], device="cpu")
    if lavc_available():
        assert type(dec).__name__ == "LavcDecompress" and out == Codec.RGB
    else:
        assert isinstance(dec, OwnH264Decompress) and out == Codec.UYVY
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            decompress_init(Codec.H264, [Codec.UYVY])


# ---------------------------------------------------------------------------
# the CLI, the loopback and the live session
# ---------------------------------------------------------------------------


def test_cli_takes_h264_and_refuses_the_lavc_decoder_by_name(capsys):
    """``-c h264`` and ``--param h264-decoder=lavc`` are both taken now (the
    lavc decoder is the port's); the latter is refused by name only where
    libavcodec is absent, when the decoder is built."""
    args = cli.build_parser().parse_args(["-t", "testcard", "-c", "h264:mode=inter:accel=device", "127.0.0.1"])
    assert cli.refusal(args) == "" and args.compress == "h264:mode=inter:accel=device"
    assert "h264" in cli.build_parser().format_help()
    assert cli.refusal(cli.build_parser().parse_args(["-d", "dummy", "--param", "h264-decoder=lavc"])) == ""
    assert cli.main(["-t", f"testcard:s={W}x{H}:f=1000:c=UYVY", "-d", "dummy", "-x", "loopback", "-c",
                     "h264:mode=inter:accel=device:gop=2", "--frames", "3", "--device", "cpu"]) == 0
    assert "3 frames processed (loopback)" in capsys.readouterr().out


@pytest.mark.parametrize("compress", ["h264:accel=device", "h264:mode=inter:accel=device:gop=3:entropy=cabac"])
def test_loopback_h264_equals_reference(compress):
    spec = f"testcard:s={W}x{H}:f=1000:c=UYVY"
    got, ref_got = [], []
    extra_displays.register_pipe_delegate("h264_port", got.append)
    ref_extra.register_pipe_delegate("h264_ref", ref_got.append)
    n_ref = RefLoopback(spec, "pipe:h264_ref", compress_spec=compress, frame_limit=4).run()
    n = LoopbackRxTx(spec, "pipe:h264_port", compress_spec=compress, frame_limit=4, device="cpu").run()
    assert n == n_ref == 4
    frames = [f for f in got if f is not None]
    ref_frames = [f for f in ref_got if f is not None]
    assert len(frames) == len(ref_frames) == 4
    for p, r in zip(frames, ref_frames):
        assert int(p.desc.color_spec) == int(r.desc.color_spec) == int(Codec.UYVY)
        assert np.array_equal(_host(p.data), np.asarray(r.data))


LIVE = "h264:mode=inter:accel=device:gop=4"
LIVE_SPEC = f"testcard:s={W}x{H}:f=60:c=UYVY:still=1"


def _expected_frames(n):
    """The UYVY frames a decoder shows for the live sessions' first n AUs:
    the encoder's reference pictures (a whole number of macroblocks, so the
    decoder's output is the reference picture)."""
    src = generate_pattern(W, H, Codec.UYVY, "bars", device="cpu")
    enc = InterEncoderDevice(W, H, qp=26, gop=4, device="cpu")
    out = []
    for _ in range(n):
        enc.encode_uyvy(src)
        y, cb, cr = enc.ref
        out.append(i420_8_to_uyvy(torch.cat([y.reshape(-1), cb.reshape(-1), cr.reshape(-1)]), W, H).numpy())
    return out


def _session(direction, n_frames=4):
    port_no = free_port_pair()
    shown = []
    if direction == "port->ref":
        recv = RefReceiver("dummy", rx_port=port_no, frame_limit=n_frames, timeout=10.0)
    else:
        params.set_commandline_param("ldgm-device", "device")  # the peel on tensors (here the CPU)
        recv = VideoReceiver("dummy", rx_port=port_no, frame_limit=n_frames, timeout=10.0, device="cpu")
    orig = recv.display.put_frame

    def put(frame, blocking=True):
        if frame is not None:
            shown.append(_host(frame.data).copy())
        orig(frame, blocking)

    recv.display.put_frame = put
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    time.sleep(0.2)
    kw = dict(compress_spec=LIVE, fec_spec="ldgm:16:8:3", tx_port=port_no, mtu=200, frame_limit=n_frames + 6)
    if direction == "port->ref":
        sender = VideoSender(LIVE_SPEC, "127.0.0.1", device="cpu", **kw)
    else:
        sender = RefSender(LIVE_SPEC, "127.0.0.1", **kw)
    _lossy(sender.session, 7, 16, 8)
    sender.run()
    t.join(timeout=15)
    assert not t.is_alive(), "the receiver did not stop"
    recovered = recv.rx_state.fec_recovered if direction == "ref->port" else None
    return shown, recovered


def test_live_session_h264_inter_ldgm_both_ways():
    """-c h264:mode=inter:accel=device -f ldgm with one data packet dropped
    per frame, port sender -> reference receiver and reference sender ->
    port receiver: every displayed frame is the encoder's picture of its
    frame, in order, and the port's peel recovered the lost packets."""
    # the reference sender builds its graphs before its receiver times out
    from ultragrid_tpu.ops.h264_tpu import InterEncoderTpu

    warm = InterEncoderTpu(W, H, qp=26, gop=4)
    for _ in range(2):
        warm.encode_uyvy(np.asarray(generate_pattern(W, H, Codec.UYVY, "bars", device="cpu")))
    expected = _expected_frames(10)
    for direction in ("port->ref", "ref->port"):
        for _attempt in range(3):
            shown, recovered = _session(direction)
            if len(shown) >= 3:
                break
        assert len(shown) >= 3, f"{direction}: {len(shown)} frames displayed in 3 attempts"
        k = 0
        for i, f in enumerate(shown):
            while k < len(expected) and not np.array_equal(f, expected[k]):
                k += 1
            assert k < len(expected), f"{direction}: displayed frame {i} is no frame of the encoder's, in order"
            k += 1
        if recovered is not None:
            assert recovered >= 1
