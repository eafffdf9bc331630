"""The wavelet and intra codecs in the port's live session, against the JAX
package on the CPU: ``-c jpegxs:100`` and ``-c openapv`` over 127.0.0.1 at
128x64, port sender -> reference receiver and reference sender -> port
receiver, LDGM with one data packet dropped per frame (the reference's
``test_jpegxs_e2e_over_rtp`` and ``test_apv_e2e_over_rtp`` with FEC and loss
added); ``--protocol loopback`` for CineForm (CFHD and UCF1) and JPEG 2000
against the reference's loopback; the CLI and the control socket's names.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules import extra_displays as ref_extra  # noqa: E402
from ultragrid_tpu.pipeline.loopback import LoopbackRxTx as RefLoopback  # noqa: E402
from ultragrid_tpu.pipeline.receiver import VideoReceiver as RefReceiver  # noqa: E402
from ultragrid_tpu.pipeline.sender import VideoSender as RefSender  # noqa: E402
from ultragrid_tpu.utils import params as ref_params  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.modules import extra_displays  # noqa: E402
from ultragrid_tpu_torch.modules.messaging import MsgChangeCompress  # noqa: E402
from ultragrid_tpu_torch.modules.video_compress import (ApvCompress, CompressDriver, JpegXsCompress,  # noqa: E402
                                                        compress_init)
from ultragrid_tpu_torch.modules.video_decompress import decompress_init  # noqa: E402
from ultragrid_tpu_torch.pipeline.loopback import LoopbackRxTx  # noqa: E402
from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import params  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

from tests.test_torch_net import _lossy, free_port_pair  # noqa: E402

W, H = 128, 64
SPEC = f"testcard:s={W}x{H}:f=30:c=UYVY:still=1"


@pytest.fixture(autouse=True)
def _clean_params():
    yield
    params.reset_params()
    ref_params.reset_params()


def _host(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _expected(compress):
    """The frame a receiver shows for the still bars under ``compress``: the
    port's encode -> decode on the CPU (equal to the reference's, see
    test_torch_wavelet.py and test_torch_apv.py)."""
    bars = generate_pattern(W, H, Codec.UYVY, "bars", device="cpu")
    comp = compress_init(compress, device="cpu").compress(VideoFrame(VideoDesc(W, H, Codec.UYVY, 30.0), [bars]))
    dec, out = decompress_init(comp.desc.color_spec, [Codec.UYVY], device="cpu")
    return dec.decompress(comp, out).data.numpy(), bars.numpy()


def _session(direction, compress, n_frames=2):
    port_no = free_port_pair()
    shown = []
    if direction == "port->ref":
        recv = RefReceiver("dummy", rx_port=port_no, frame_limit=n_frames, timeout=20.0)
    else:
        params.set_commandline_param("ldgm-device", "device")  # the peel on tensors (here the CPU)
        recv = VideoReceiver("dummy", rx_port=port_no, frame_limit=n_frames, timeout=20.0, device="cpu")
    orig = recv.display.put_frame

    def put(frame, blocking=True):
        if frame is not None:
            shown.append(_host(frame.data).copy())
        orig(frame, blocking)

    recv.display.put_frame = put
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    time.sleep(0.2)
    kw = dict(compress_spec=compress, fec_spec="ldgm:16:8:3", tx_port=port_no, mtu=400, frame_limit=n_frames + 6)
    if direction == "port->ref":
        sender = VideoSender(SPEC, "127.0.0.1", device="cpu", **kw)
    else:
        sender = RefSender(SPEC, "127.0.0.1", **kw)
    _lossy(sender.session, 5, 16, 8)
    sender.run()
    t.join(timeout=25)
    assert not t.is_alive(), "the receiver did not stop"
    recovered = recv.rx_state.fec_recovered if direction == "ref->port" else None
    return shown, recovered


@pytest.mark.parametrize("compress", ["jpegxs:100", "openapv"])
@pytest.mark.parametrize("direction", ["port->ref", "ref->port"])
def test_live_session_both_ways(compress, direction):
    """Every displayed frame is the codec's decode of the bars (for the
    lossless jpegxs:100 the bars themselves), and the port's peel recovered
    the dropped packets."""
    want, bars = _expected(compress)
    if compress == "jpegxs:100":
        assert np.array_equal(want, bars)
    for _attempt in range(3):
        shown, recovered = _session(direction, compress)
        if shown:
            break
    assert shown, f"{direction} {compress}: nothing displayed in 3 attempts"
    for f in shown:
        assert np.array_equal(f, want)
    if recovered is not None:
        assert recovered >= 1


@pytest.mark.parametrize("compress,n", [("cineform", 3), ("cineform:100", 2), ("j2k:90", 2)])
def test_loopback_equals_reference(compress, n):
    spec = f"testcard:s={W}x{H}:f=1000:c=UYVY"
    got, ref_got = [], []
    extra_displays.register_pipe_delegate("codec_port", got.append)
    ref_extra.register_pipe_delegate("codec_ref", ref_got.append)
    assert RefLoopback(spec, "pipe:codec_ref", compress_spec=compress, frame_limit=n).run() == n
    assert LoopbackRxTx(spec, "pipe:codec_port", compress_spec=compress, frame_limit=n, device="cpu").run() == n
    frames = [f for f in got if f is not None]
    ref_frames = [f for f in ref_got if f is not None]
    assert len(frames) == len(ref_frames) == n
    for p, r in zip(frames, ref_frames):
        assert int(p.desc.color_spec) == int(r.desc.color_spec)
        assert isinstance(p.data, torch.Tensor) and np.array_equal(_host(p.data), np.asarray(r.data))


def test_cli_and_control_socket_names(capsys):
    assert all(name in cli.build_parser().format_help() for name in ("jpegxs", "cineform", "openapv", "j2k"))
    assert cli.main(["-t", f"testcard:s={W}x{H}:f=1000:c=UYVY", "-d", "dummy", "-x", "loopback", "-c", "openapv:qp=0",
                     "--frames", "2", "--device", "cpu"]) == 0
    assert "2 frames processed (loopback)" in capsys.readouterr().out
    # the control socket's "compress <NAME>" reaches the modules through
    # compress_init's lowercase lookup
    assert isinstance(compress_init("JPEGXS:100", device="cpu"), JpegXsCompress)
    assert isinstance(compress_init("OpenAPV:qp=0", device="cpu"), ApvCompress)
    drv = CompressDriver("jpeg:80", device="cpu")
    try:
        assert drv.module.msg_callback(MsgChangeCompress("CINEFORM:100")).code == 200
        assert type(drv.impl).__name__ == "CineformCompress" and drv.impl.quality == 100
    finally:
        drv.stop()
