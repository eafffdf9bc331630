"""Standards-mode sessions and RTSP capture, the port against the JAX
package, on the CPU over 127.0.0.1.

``--rtp-standard`` (JPEG as RFC 2435 on PT 26): the port's sender to the
port's receiver, the port's sender to the reference's receiver and the
reference's sender to the port's receiver, every shown frame the CPU decode
of the sender's JPEG file; the fast receive path's hand-back of a whole
recvmmsg batch of PT 26 datagrams, where the reference's drops those beyond
64 (ROADMAP F11).  ``RtspCapture`` (``-t rtsp:``) against the port's and the
reference's ``RtspServer``, for JPEG (pumped by each package's
``Tx(rfc2435=True)``) and for H.264 (the port's encoder's access units cut
by ``rtpdec_h264.packetize``, announced with ``sprop-parameter-sets``): each
frame equal to the CPU decode of its file, or to the encoder's reference
picture.  The CLI's ``--rtsp`` sender and its ``-t rtsp:`` client, and the
clash on port 8554 of the RTSP and SDP servers, which both packages show
(ROADMAP F10).  The servers bind ports from the OS (patched in both
packages), never 8554 itself; UDP ports come from the OS.  UDP on localhost
may drop under load, so a session is retried up to three times.
"""

import base64
import functools
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.net import rtsp as ref_rtsp  # noqa: E402
from ultragrid_tpu.net import transmit as ref_tx  # noqa: E402
from ultragrid_tpu.net.rtp import RtpSession as RefSession  # noqa: E402
from ultragrid_tpu.net.video_rx import VideoRxState as RefRxState  # noqa: E402
from ultragrid_tpu.net.vrx_fast import FastVideoRx as RefFastRx  # noqa: E402
from ultragrid_tpu.pipeline.receiver import VideoReceiver as RefReceiver  # noqa: E402
from ultragrid_tpu.pipeline.sender import VideoSender as RefSender  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402
from ultragrid_tpu.utils import sdp as ref_sdp  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.modules.rtsp_capture import RtspCapture  # noqa: E402
from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress  # noqa: E402
from ultragrid_tpu_torch.net import rtpdec_h264, rtsp, transmit  # noqa: E402
from ultragrid_tpu_torch.net.rtp import RtpSession  # noqa: E402
from ultragrid_tpu_torch.net.video_rx import VideoRxState  # noqa: E402
from ultragrid_tpu_torch.net.vrx_fast import FastVideoRx  # noqa: E402
from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice  # noqa: E402
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder, _parse_headers  # noqa: E402
from ultragrid_tpu_torch.ops.planar import i420_8_to_uyvy  # noqa: E402
from ultragrid_tpu_torch.pipeline import sender as sender_mod  # noqa: E402
from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import params, sdp  # noqa: E402

SPEC = "testcard:s=128x64:f=60:c=UYVY:still=1"


@pytest.fixture(autouse=True)
def _clean_params():
    yield
    params.reset_params()


def free_port_pair() -> int:
    """A UDP port p with p + 1 free too (RTP and RTCP), from the OS."""
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


def free_tcp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def servers_on(monkeypatch):
    """Point the RTSP and SDP servers of both packages' senders at ``port``
    (0: a port from the OS each)."""
    def point(rtsp_port=0, sdp_port=0):
        monkeypatch.setattr(sender_mod, "RtspServer", functools.partial(rtsp.RtspServer, port=rtsp_port))
        monkeypatch.setattr(sender_mod, "SdpHttpServer", functools.partial(sdp.SdpHttpServer, port=sdp_port))
        monkeypatch.setattr(ref_rtsp, "RtspServer", functools.partial(ref_rtsp.RtspServer, port=rtsp_port))
        monkeypatch.setattr(ref_sdp, "SdpHttpServer", functools.partial(ref_sdp.SdpHttpServer, port=sdp_port))
    point()
    return point


def _close_servers(sender):
    for srv in (sender.rtsp_server, sender.sdp_server):
        if srv is not None:
            srv.close()


def _cpu_decode(jpeg: bytes) -> np.ndarray:
    hdr = _parse_headers(jpeg)
    frame = VideoFrame(VideoDesc(hdr["w"], hdr["h"], Codec.JPEG, 30.0), [np.frombuffer(jpeg, np.uint8)])
    return JpegDecompress(device="cpu").decompress(frame, Codec.UYVY).data.numpy()


def _host(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


# ---------------------------------------------------------------------------
# --rtp-standard sessions
# ---------------------------------------------------------------------------


def _standards_session(direction, n_frames=3):
    port_no = free_port_pair()
    shown, files = [], []
    if direction.endswith("->ref"):
        recv = RefReceiver("dummy", rx_port=port_no, frame_limit=n_frames, timeout=10.0)
    else:
        recv = VideoReceiver("dummy", rx_port=port_no, frame_limit=n_frames, timeout=10.0, device="cpu")
    orig = recv.display.put_frame
    recv.display.put_frame = lambda f, blocking=True: (f is not None and shown.append(_host(f.data).copy()),
                                                       orig(f, blocking))
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    time.sleep(0.2)
    if direction.startswith("port"):
        sender = VideoSender(SPEC, "127.0.0.1", compress_spec="jpeg", tx_port=port_no, frame_limit=n_frames + 6,
                             rtp_standard=True, device="cpu")
    else:
        sender = RefSender(SPEC, "127.0.0.1", compress_spec="jpeg", tx_port=port_no, frame_limit=n_frames + 6,
                           rtp_standard=True)
    assert sender.tx.rfc2435 and sender.sdp_server is not None
    send = sender.tx.send_video
    sender.tx.send_video = lambda s, f: (files.append(_host(f.data).tobytes()), send(s, f))[1]
    try:
        sender.run()
    finally:
        _close_servers(sender)
    t.join(timeout=15)
    assert not t.is_alive(), "the receiver did not stop"
    return shown, files


@pytest.mark.parametrize("direction", ["port->port", "port->ref", "ref->port"])
def test_standards_session(direction, servers_on):
    for _attempt in range(3):
        shown, files = _standards_session(direction)
        if len(shown) >= 2:
            break
    assert len(shown) >= 2, f"{direction}: {len(shown)} frames shown in 3 attempts"
    assert len(set(files)) == 1  # a still testcard: one file, the same in both packages
    want = _cpu_decode(files[0])
    for f in shown:
        assert np.array_equal(f, want)


def test_fast_rx_hands_back_a_whole_batch_of_standards_packets():
    """150 PT 26 datagrams waiting in the socket: the port's fast receive
    path hands every one to the playout buffer; the reference's keeps 64
    of a batch and drops the rest (ROADMAP F11)."""
    got = {}
    for name, session_cls, state, fast_cls in (("port", RtpSession, VideoRxState(device="cpu"), FastVideoRx),
                                               ("ref", RefSession, RefRxState(), RefFastRx)):
        port_no = free_port_pair()
        rx = session_cls(addr=None, rx_port=port_no, tx_port=0)
        fast = fast_cls(rx, state)
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            for i in range(150):
                tx.sendto(struct.pack("!BBHII", 0x80, 26, i, 9000, 7) + bytes(800), ("127.0.0.1", port_no))
            time.sleep(0.3)
            got[name] = [p.seq for p in fast.drain(timeout=0.05)]
        finally:
            tx.close()
            fast.close()
            rx.close()
    assert got["port"] == list(range(150))
    assert got["ref"] == list(range(64))


# ---------------------------------------------------------------------------
# RTSP capture against both servers
# ---------------------------------------------------------------------------


def _jpeg_frame(seed=3):
    rng = np.random.default_rng(seed)
    uy = (np.linspace(30, 220, 256)[None, :] + rng.normal(0, 5, (96, 256))).clip(16, 235).astype(np.uint8)
    return JpegEncoder(128, 96).encode(uy, device="cpu")


def _pump_on_play(which, make_payloads, stop, fps=30.0):
    """on_play: a thread sending the stream to the client that PLAYed."""
    def on_play(addr, port):
        def pump():
            sess = (RtpSession if which == "port" else RefSession)(addr=addr, rx_port=0, tx_port=port)
            i = 0
            while not stop.is_set():
                make_payloads(sess, i)
                i += 1
                time.sleep(1 / fps)
            sess.close()

        threading.Thread(target=pump, daemon=True).start()

    return on_play


@pytest.mark.parametrize("server", ["port", "ref"])
def test_rtsp_capture_jpeg(server):
    jpeg = _jpeg_frame()
    want = _cpu_decode(jpeg.tobytes())
    stop = threading.Event()
    if server == "port":
        tx = transmit.Tx(mtu=600, rfc2435=True, device="cpu")
        frame = VideoFrame(VideoDesc(128, 96, Codec.JPEG, 30.0), [jpeg])
        srv_cls = rtsp.RtspServer
    else:
        tx = ref_tx.Tx(mtu=600, rfc2435=True)
        frame = RefFrame(RefDesc(128, 96, RefCodec.JPEG, 30.0), [jpeg])
        srv_cls = ref_rtsp.RtspServer
    srv = srv_cls([("video", 5004, 26, "JPEG", 90000)], port=0,
                  on_play=_pump_on_play(server, lambda sess, i: tx.send_video(sess, frame), stop))
    try:
        cap = RtspCapture(f"rtsp://127.0.0.1:{srv.port}/ug", device="cpu")
        got = []
        deadline = time.time() + 15
        while len(got) < 3 and time.time() < deadline:
            f, _ = cap.grab()
            if f is not None:
                got.append(f)
        cap.done()
    finally:
        stop.set()
        srv.close()
    assert len(got) == 3 and cap.decode_failures == 0
    for f in got:
        assert f.desc.color_spec == Codec.UYVY and (f.desc.width, f.desc.height) == (128, 96)
        assert f.data.device.type == "cpu" and np.array_equal(f.data.numpy(), want)


def _h264_stream(n=6):
    rng = np.random.default_rng(5)
    base = (np.linspace(30, 220, 2 * 96 + 8 * n)[None, :] + rng.normal(0, 4, (64 + n, 2 * 96 + 8 * n)))
    base = base.clip(16, 235).astype(np.uint8)
    enc = InterEncoderDevice(96, 64, qp=26, gop=3, device="cpu")
    aus, want = [], []
    for i in range(n):
        aus.append(enc.encode_uyvy(np.ascontiguousarray(base[i:i + 64, 4 * i:4 * i + 192])))
        y, cb, cr = enc.ref
        flat = torch.cat([y[:64, :96].reshape(-1), cb[:32, :48].reshape(-1), cr[:32, :48].reshape(-1)])
        want.append(i420_8_to_uyvy(flat, 96, 64).numpy())
    return aus, want


@pytest.mark.parametrize("server", ["port", "ref"])
def test_rtsp_capture_h264_with_sprop(server, monkeypatch):
    aus, want = _h264_stream()
    nals = {rtpdec_h264.nal_type(n[0]): n for n in rtpdec_h264.packetize(aus[0], mtu_payload=1 << 20)}
    sprop = ",".join(base64.b64encode(nals[t]).decode() for t in (rtpdec_h264.NAL_SPS, rtpdec_h264.NAL_PPS))
    mod = rtsp if server == "port" else ref_rtsp
    make_sdp = mod.make_sdp
    monkeypatch.setattr(mod, "make_sdp", lambda ip, streams, name: make_sdp(ip, streams, name) + (
        f"a=fmtp:96 packetization-mode=1;sprop-parameter-sets={sprop}\r\n"))
    stop = threading.Event()

    def send_au(sess, i):
        if i < len(aus):
            pkts = rtpdec_h264.packetize(aus[i], mtu_payload=120)  # FU-A for the larger NAL units
            for j, p in enumerate(pkts):
                sess.send_data_hdr(i * 3000, 96, j == len(pkts) - 1, b"", p)

    srv = mod.RtspServer([("video", 5004, 96, "H264", 90000)], port=0, on_play=_pump_on_play(server, send_au, stop))
    try:
        cap = RtspCapture(f"rtsp://127.0.0.1:{srv.port}/camera", device="cpu")
        assert cap.media.fmtp["sprop-parameter-sets"] == sprop and cap._depack.sps == nals[rtpdec_h264.NAL_SPS]
        got = []
        deadline = time.time() + 20
        while len(got) < len(aus) and time.time() < deadline:
            f, _ = cap.grab()
            if f is not None:
                got.append(f.data.numpy())
        cap.done()
    finally:
        stop.set()
        srv.close()
    assert cap.decode_failures == 0 and len(got) >= len(aus) - 1
    k = 0
    for g in got:  # in order, each the encoder's reference picture
        while k < len(want) and not np.array_equal(g, want[k]):
            k += 1
        assert k < len(want), "a decoded frame is no later reference picture"


SLOW_AUS, SLOW_AU_BYTES, SLOW_FPS, SLOW_DECODE_S = 30, 24000, 60.0, 0.1
SLOW_RECV_BUF = 256 * 1024  # the port's socket asks for this, not RECV_BUF: the stream outruns it


@pytest.mark.parametrize("package", ["port", "reference"])
def test_rtsp_capture_keeps_every_access_unit_behind_a_slow_decoder(package, monkeypatch):
    """A camera paced at 60 access units a second (30 of 24 KB, H.264 FU-A
    at 1,200 bytes) into a capture whose decode takes 0.1 s an access unit
    (``_to_frame`` slowed by a sleep; ``decompress=no``), the port's socket
    asking for 256 KiB, less than the 720 KB stream.  The port's rx thread
    only reads and depacketizes, so every access unit comes out, in order.
    The reference decodes on its rx thread, its socket overflows meanwhile
    and access units come out short or not at all (recorded, not
    repaired)."""
    from ultragrid_tpu_torch.modules import rtsp_capture
    from ultragrid_tpu.modules.rtsp_capture import RtspCapture as RefRtspCapture

    rng = np.random.default_rng(8)
    aus = [b"\x00\x00\x00\x01\x41" + rng.integers(1, 256, SLOW_AU_BYTES, dtype=np.uint8).tobytes()
           for _ in range(SLOW_AUS)]
    cls = RtspCapture if package == "port" else RefRtspCapture
    to_frame = cls._to_frame

    def slow_to_frame(self, payload):
        time.sleep(SLOW_DECODE_S)
        return to_frame(self, payload)

    monkeypatch.setattr(cls, "_to_frame", slow_to_frame)
    monkeypatch.setattr(rtsp_capture, "RECV_BUF", SLOW_RECV_BUF)

    def on_play(addr, port):
        def pump():
            sess = RtpSession(addr=addr, rx_port=0, tx_port=port)
            t_next = time.perf_counter()
            for i, au in enumerate(aus):
                pkts = rtpdec_h264.packetize(au, mtu_payload=1200)
                for j, p in enumerate(pkts):
                    sess.send_data_hdr(i * 1500, 96, j == len(pkts) - 1, b"", p)
                t_next += 1 / SLOW_FPS
                time.sleep(max(0.0, t_next - time.perf_counter()))
            sess.close()

        threading.Thread(target=pump, daemon=True).start()

    srv = rtsp.RtspServer([("video", 5004, 96, "H264", 90000)], port=0, on_play=on_play)
    got = []
    try:
        url = f"rtsp://127.0.0.1:{srv.port}/camera:decompress=no"
        cap = RtspCapture(url, device="cpu") if package == "port" else RefRtspCapture(url)
        last = time.monotonic()
        while len(got) < SLOW_AUS and time.monotonic() - last < 1.5:
            f, _ = cap.grab()
            if f is not None:
                got.append(bytes(np.asarray(f.data)))
                last = time.monotonic()
        cap.done()
    finally:
        srv.close()
    if package == "port":
        assert got == aus
    else:
        assert len(got) < SLOW_AUS or got != aus


def test_rtsp_capture_grammar_and_no_video():
    with pytest.raises(ValueError, match="usage"):
        RtspCapture("http://x/y", device="cpu")
    srv = rtsp.RtspServer([("audio", 5006, 0, "PCMU", 8000)], port=0)
    try:
        with pytest.raises(ValueError, match="no video media"):
            RtspCapture(f"rtsp://127.0.0.1:{srv.port}/a:decompress=no", device="cpu")
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the CLI, and the 8554 clash
# ---------------------------------------------------------------------------


def test_cli_rtsp_sender_and_rtsp_capture(servers_on, capsys):
    """``uv -t testcard --rtsp`` serves (no host: it waits for PLAY) and
    ``uv -t rtsp:rtsp://...`` plays it into a local loop."""
    for _attempt in range(3):
        rtsp_port = free_tcp_port()
        servers_on(rtsp_port)
        rc = {}
        tx = threading.Thread(target=lambda: rc.setdefault("tx", cli.main(
            ["-t", "testcard:s=128x64:f=30:c=UYVY", "-c", "jpeg", "--rtsp", "--frames", "90", "-n", "0",
             "-P", str(free_port_pair()), "--device", "cpu"])), daemon=True)
        tx.start()
        time.sleep(0.5)
        rc["rx"] = cli.main(["-t", f"rtsp:rtsp://127.0.0.1:{rtsp_port}/ultragrid", "-d", "dummy",
                             "--frames", "3", "--device", "cpu"])
        tx.join(timeout=20)
        if rc == {"tx": 0, "rx": 0}:
            break
    assert rc == {"tx": 0, "rx": 0}
    out = capsys.readouterr()
    assert "3 frames processed" in out.out
    assert "sent 90 frames" in out.err


@pytest.mark.parametrize("package", ["port", "ref"])
def test_rtsp_and_sdp_servers_clash_on_one_port(package, servers_on, capfd):
    """Under ``--rtsp`` (which sets ``rtp_standard``) the RTSP server and the
    SDP HTTP server both want port 8554: the RTSP server binds first and the
    SDP server is logged unavailable, in both packages (ROADMAP F10).  The
    clash is shown on one port from the OS, standing in for 8554."""
    port = free_tcp_port()
    servers_on(port, port)
    if package == "port":
        sender = VideoSender(SPEC, None, compress_spec="jpeg", tx_port=free_port_pair(), rtp_standard=True,
                             rtsp=True, device="cpu")
    else:
        sender = RefSender(SPEC, None, compress_spec="jpeg", tx_port=free_port_pair(), rtp_standard=True, rtsp=True)
    try:
        assert sender.rtsp_server is not None and sender.rtsp_server.port == port
        assert sender.sdp_server is None
    finally:
        _close_servers(sender)
        sender.session.close()
    err = capfd.readouterr().err
    assert re.search(r"SDP HTTP server unavailable: \[Errno \d+\] Address already in use", err)
    assert ref_sdp.DEFAULT_SDP_HTTP_PORT == ref_rtsp.DEFAULT_RTSP_PORT == 8554
