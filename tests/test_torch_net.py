"""The port's transport and live sessions against the JAX package's, on the
CPU.

Payload headers; the packets of ``Tx.send_video`` (recorded before the
socket, and as datagrams through the C batch sender, with ssrc, sequence
and timestamp fixed) byte-equal to the reference ``Tx``'s; reassembly of the
reference's packets by the port's ``VideoRxState`` and ``FastVideoRx`` and
the other way round; and live sessions over 127.0.0.1 in both directions
(port sender -> reference receiver, reference sender -> port receiver) with
``none``, ``jpeg`` and ``jpeg`` + LDGM with seeded packet loss: the
displayed frames are equal.  Inputs are made from a seed with numpy; UDP
ports come from the OS; every thread is joined with a timeout.  UDP on
localhost may drop under load, so a live session is retried up to three
times, as the reference's tests do.
"""

import random
import socket
import struct
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.net import rtp_types as ref_rt  # noqa: E402
from ultragrid_tpu.net import transmit as ref_tx  # noqa: E402
from ultragrid_tpu.net.pbuf import PlayoutBuffer as RefPbuf  # noqa: E402
from ultragrid_tpu.net.rtp import RtpSession as RefSession  # noqa: E402
from ultragrid_tpu.net.video_rx import VideoRxState as RefRxState  # noqa: E402
from ultragrid_tpu.net.vrx_fast import FastVideoRx as RefFastRx  # noqa: E402
from ultragrid_tpu.pipeline.receiver import VideoReceiver as RefReceiver  # noqa: E402
from ultragrid_tpu.pipeline.sender import VideoSender as RefSender  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import InterlacingType as RefInterlacing  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch.net import rtp_types as rt  # noqa: E402
from ultragrid_tpu_torch.net import transmit  # noqa: E402
from ultragrid_tpu_torch.net.pbuf import PlayoutBuffer  # noqa: E402
from ultragrid_tpu_torch.net.rtp import RtpSession  # noqa: E402
from ultragrid_tpu_torch.net.video_rx import VideoRxState  # noqa: E402
from ultragrid_tpu_torch.net.vrx_fast import FastVideoRx  # noqa: E402
from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402
from ultragrid_tpu_torch.types import Codec, InterlacingType, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import params  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_params():
    yield
    params.reset_params()


def free_port_pair() -> int:
    """An even UDP port p with p + 1 free too (RTP and RTCP), from the OS."""
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


def _host(data):
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


# ---------------------------------------------------------------------------
# payload headers, packet sizes
# ---------------------------------------------------------------------------

_DESCS = [(1920, 1080, Codec.UYVY, 60.0, InterlacingType.PROGRESSIVE),
          (3840, 2160, Codec.JPEG, 59.94, InterlacingType.PROGRESSIVE),
          (720, 576, Codec.v210, 25.0, InterlacingType.INTERLACED_MERGED),
          (64, 32, Codec.RGB, 0.5, InterlacingType.PROGRESSIVE)]


@pytest.mark.parametrize("w,h,codec,fps,interl", _DESCS, ids=[d[2].name for d in _DESCS])
def test_video_header_equals_reference(w, h, codec, fps, interl):
    desc = VideoDesc(w, h, codec, fps, interl)
    ref_desc = RefDesc(w, h, RefCodec(int(codec)), fps, RefInterlacing(int(interl)))
    hdr = rt.pack_video_header(desc, 0x12345, 4096, 1 << 20, 3)
    assert hdr == ref_rt.pack_video_header(ref_desc, 0x12345, 4096, 1 << 20, 3)
    sub, buf, off, ln, got = rt.parse_video_header(hdr)
    rsub, rbuf, roff, rln, rgot = ref_rt.parse_video_header(hdr)
    assert (sub, buf, off, ln) == (rsub, rbuf, roff, rln) == (3, 0x12345, 4096, 1 << 20)
    assert (got.width, got.height, int(got.color_spec), got.fps, int(got.interlacing)) == \
        (rgot.width, rgot.height, int(rgot.color_spec), rgot.fps, int(rgot.interlacing))


def test_fec_header_and_packet_sizes_equal_reference():
    hdr = rt.pack_fec_header(7, 1440, 99999, 256, 26, 5, 1, 2)
    assert hdr == ref_rt.pack_fec_header(7, 1440, 99999, 256, 26, 5, 1, 2)
    assert rt.parse_fec_header(hdr) == ref_rt.parse_fec_header(hdr)
    from ultragrid_tpu.ops.fec import FecDesc as RefFecDesc
    from ultragrid_tpu_torch.ops.fec import FecDesc

    for n, codec, w, fec, mtu in ((1920 * 1080 * 2, Codec.UYVY, 1920, None, 1440),
                                  (300001, Codec.JPEG, 1920, None, 1440),
                                  (123456, Codec.JPEG, 1920, ("ldgm", 256, 26, 5, 1, 482), 1420),
                                  (123456, Codec.JPEG, 1920, ("rs", 200, 40, 0, 0, 618), 1420)):
        port = transmit.get_packet_sizes(n, codec, w, FecDesc(*fec) if fec else None, mtu)
        ref = ref_tx.get_packet_sizes(n, RefCodec(int(codec)), w, RefFecDesc(*fec) if fec else None, mtu)
        assert port == ref and sum(port) == n


# ---------------------------------------------------------------------------
# Tx.send_video
# ---------------------------------------------------------------------------


class _Recorder:
    """Stands in for an RtpSession: records each send_batch call as the
    datagrams it would send (RTP header with seq from 0 and a fixed ssrc)."""

    def __init__(self):
        self.packets = []
        self.bytes_sent = 0

    def send_batch(self, ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns=0):
        data = np.asarray(data, np.uint8).reshape(-1)
        for i, (off, sz) in enumerate(zip(offsets, sizes)):
            m = m_last and i == len(sizes) - 1
            rtp_hdr = struct.pack("!BBHII", 0x80, (0x80 if m else 0) | pt, len(self.packets) & 0xFFFF,
                                  ts & 0xFFFFFFFF, 0x1234)
            self.packets.append(rtp_hdr + bytes(hdrs[i]) + data[off: off + sz].tobytes())
        return len(sizes)


def _uyvy(w, h, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, 2 * w), dtype=np.uint8)


def _jpeg_like(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


_TX = [("raw", "none"), ("raw", "ldgm:16:8:3"), ("raw", "mult:2"), ("jpeg", "none"),
       ("jpeg", "ldgm:256:26:5"), ("jpeg", "rs:16:20"), ("tiles", "ldgm:16:8:3")]


@pytest.mark.parametrize("kind,fec", _TX, ids=[f"{k}-{f}" for k, f in _TX])
def test_tx_packets_equal_reference(kind, fec):
    w, h = 96, 64
    if kind == "jpeg":
        data, codec, tiles = _jpeg_like(40000), Codec.JPEG, 1
    else:
        data, codec, tiles = _uyvy(w, h), Codec.UYVY, 1
    if kind == "tiles":
        tiles, w = 2, w // 2
        parts = [data[:, : 2 * w].copy(), data[:, 2 * w:].copy()]
    else:
        parts = [data]
    desc = VideoDesc(w, h, codec, 30.0, tile_count=tiles)
    ref_desc = RefDesc(w, h, RefCodec(int(codec)), 30.0, tile_count=tiles)
    port_rec, ref_rec = _Recorder(), _Recorder()
    port = transmit.Tx(mtu=1500, fec_spec=fec, device="cpu")
    ref = ref_tx.Tx(mtu=1500, fec_spec=fec)
    for i in range(2):  # two frames: the buffer id advances
        ts = 10.0 + i / 30
        port.send_video(port_rec, VideoFrame(desc, [torch.as_tensor(p) for p in parts], timestamp=ts))
        ref.send_video(ref_rec, RefFrame(ref_desc, list(parts), timestamp=ts))
    assert port_rec.packets == ref_rec.packets
    assert len(port_rec.packets) > 2


class _PacedRecorder(_Recorder):
    """A _Recorder that keeps each batch's pacing too."""

    def __init__(self):
        super().__init__()
        self.paces = []

    def send_batch(self, ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns=0):
        self.paces.append(pace_ns)
        return super().send_batch(ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns)


_ROUTES = [("jpeg", "ldgm:256:26:5"), ("jpeg", "ldgm:16:8:3"), ("raw", "ldgm:16:8:3"), ("tiles", "ldgm:32:12:3")]


@pytest.mark.parametrize("kind,fec", _ROUTES, ids=[f"{k}-{f}" for k, f in _ROUTES])
def test_tx_tensor_route_sends_the_host_routes_datagrams(kind, fec, monkeypatch):
    """The same frames as host arrays and as tensors (a JPEG file as
    ``JpegCompress`` leaves it, ``device.DeviceFile``; a frame; tiles): an
    array's LDGM buffer is built by the C encoder, a tensor's on the
    tensor's own device (``LdgmSession.encode_tensor``, here the CPU), and
    the datagrams (headers, payloads, order) and their pacing are equal.
    ``fec_routes`` counts both where their buffers were built, the host."""
    from ultragrid_tpu_torch.device import DeviceFile
    from ultragrid_tpu_torch.ops.fec import LdgmSession

    calls = {"tensor": 0, "host": 0}
    on_tensor, on_host = LdgmSession.encode_tensor, LdgmSession.encode

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(LdgmSession, "encode_tensor", count("tensor", on_tensor))
    monkeypatch.setattr(LdgmSession, "encode", count("host", on_host))
    w, h, tiles = 96, 64, 1
    recs = {}
    for route in ("array", "tensor"):
        tx = transmit.Tx(mtu=1500, fec_spec=fec, device="cpu")
        rec = recs[route] = _PacedRecorder()
        for i in range(3):  # three frames, each of another size: other pads
            if kind == "jpeg":
                parts, codec = [_jpeg_like(20000 + 997 * i, seed=i)], Codec.JPEG
            else:
                parts, codec = [_uyvy(w, h, seed=i)], Codec.UYVY
            if kind == "tiles":
                tiles = 2
                parts = [parts[0][:, : w].copy(), parts[0][:, w:].copy()]
            if route == "tensor":
                parts = [torch.as_tensor(p).reshape(-1).as_subclass(DeviceFile) if kind == "jpeg"
                         else torch.as_tensor(p) for p in parts]
            desc = VideoDesc(w // tiles, h, codec, 24.0, tile_count=tiles)
            tx.send_video(rec, VideoFrame(desc, parts, timestamp=3.0 + i / 24))
        assert tx.fec_routes == {"card": 0, "host": 3 * tiles}, route
    assert calls == {"tensor": 3 * tiles, "host": 3 * tiles}
    assert recs["tensor"].packets == recs["array"].packets and len(recs["array"].packets) > 3 * tiles
    assert recs["tensor"].paces == recs["array"].paces


def test_rtp_batch_datagrams_equal_reference():
    """The C batch sender through both sessions: the same datagrams."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(5)
    port_rx = rx.getsockname()[1]
    got = {}
    try:
        for name, cls, tx_cls in (("port", RtpSession, transmit.Tx), ("ref", RefSession, ref_tx.Tx)):
            s = cls(addr="127.0.0.1", rx_port=0, tx_port=port_rx)
            s.ssrc, s.seq = 0xCAFE, 65530
            if name == "port":
                frame = VideoFrame(VideoDesc(64, 32, Codec.UYVY, 30.0), [torch.as_tensor(_uyvy(64, 32))], 5.0)
                tx = tx_cls(mtu=600, fec_spec="ldgm:8:4:3", bitrate=transmit.RATE_UNLIMITED, device="cpu")
            else:
                frame = RefFrame(RefDesc(64, 32, RefCodec.UYVY, 30.0), [_uyvy(64, 32)], timestamp=5.0)
                tx = tx_cls(mtu=600, fec_spec="ldgm:8:4:3", bitrate=ref_tx.RATE_UNLIMITED)
            n = tx.send_video(s, frame)
            got[name] = [rx.recvfrom(9200)[0] for _ in range(n)]
            s.close()
    finally:
        rx.close()
    assert got["port"] == got["ref"] and len(got["port"]) > 4


# ---------------------------------------------------------------------------
# reassembly, both ways
# ---------------------------------------------------------------------------


def _packets(sender_side, fec, kind="raw"):
    """Datagrams of two frames from the port's or the reference's Tx."""
    rec = _Recorder()
    if kind == "raw":
        data, codec = _uyvy(96, 64, seed=9), Codec.UYVY
    else:
        data, codec = _jpeg_like(20000, seed=9), Codec.JPEG
    if sender_side == "port":
        tx = transmit.Tx(mtu=1500, fec_spec=fec, device="cpu")
        for i in range(2):
            tx.send_video(rec, VideoFrame(VideoDesc(96, 64, codec, 30.0), [torch.as_tensor(data)], 1.0 + i))
    else:
        tx = ref_tx.Tx(mtu=1500, fec_spec=fec)
        for i in range(2):
            tx.send_video(rec, RefFrame(RefDesc(96, 64, RefCodec(int(codec)), 30.0), [data], timestamp=1.0 + i))
    return rec.packets, data


def _reassemble(packets, rx_state, pbuf, session_cls, drop=()):
    """Feed datagrams through a playout buffer into rx_state; return the
    frames (FEC jobs decoded)."""
    parser = session_cls.__new__(session_cls)
    parser.bytes_received = parser.packets_received = 0
    parser.rtcp = None
    out = []

    def cb(node):
        res = rx_state.reassemble(node)
        if res is not None:
            out.append(rx_state.decode_fec_job(res) if res.__class__.__name__ == "FecJob" else res)
        return True

    now = time.monotonic()
    for i, pkt in enumerate(packets):
        if i not in drop:
            pbuf.insert(parser._parse(pkt, now))
    for t in (now + 1, now + 2, now + 3):
        while pbuf.decode(t, cb):
            pass
    return out


@pytest.mark.parametrize("fec,kind", [("none", "raw"), ("ldgm:16:8:3", "raw"), ("rs:8:12", "jpeg"),
                                      ("ldgm:32:16:4", "jpeg")])
@pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
def test_reassembly_both_ways(fec, kind, direction):
    sender = "ref" if direction == "ref->port" else "port"
    packets, data = _packets(sender, fec, kind)
    drop = {1, 4} if fec != "none" else set()  # lost symbols the FEC recovers
    if direction == "ref->port":
        frames = _reassemble(packets, VideoRxState(device="cpu"), PlayoutBuffer(0.0), RtpSession, drop)
    else:
        frames = _reassemble(packets, RefRxState(), RefPbuf(0.0), RefSession, drop)
    assert len(frames) == 2
    for f in frames:
        assert np.array_equal(_host(f.data).reshape(-1), data.reshape(-1))


@pytest.mark.parametrize("fec,kind", [("none", "raw"), ("ldgm:16:8:3", "jpeg")])
@pytest.mark.parametrize("direction", ["ref->port", "port->ref"])
def test_fast_rx_reassembles_the_other_side(fec, kind, direction):
    """The C depacketizer path: datagrams over 127.0.0.1 into FastVideoRx."""
    sender = "ref" if direction == "ref->port" else "port"
    packets, data = _packets(sender, fec, kind)
    port_no = free_port_pair()
    if direction == "ref->port":
        session = RtpSession(addr=None, rx_port=port_no, tx_port=0)
        fast = FastVideoRx(session, VideoRxState(device="cpu"))
    else:
        session = RefSession(addr=None, rx_port=port_no, tx_port=0)
        fast = RefFastRx(session, RefRxState())
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    frames = []
    try:
        for pkt in packets:
            tx.sendto(pkt, ("127.0.0.1", port_no))
        deadline = time.monotonic() + 10
        while len(frames) < 2 and time.monotonic() < deadline:
            assert fast.drain(timeout=0.01) == []
            for out in fast.poll(time.monotonic(), 0.0):
                frames.append(fast.rx_state.decode_fec_job(out) if out.__class__.__name__ == "FecJob" else out)
    finally:
        tx.close()
        fast.close()
        session.close()
    assert len(frames) == 2
    for f in frames:
        assert np.array_equal(_host(f.data).reshape(-1), data.reshape(-1))


@pytest.mark.parametrize("side", ["port", "ref"])
def test_fast_rx_a_later_frame_wider_than_the_slots(side):
    """ROADMAP F12 for a later, larger frame: a 64x32 frame, a 384x360 one
    (270 KiB, past the 256 KiB slots) and a 64x32 one in one receive batch
    at MTU 9000.  The port holds the batch at the wide frame, grows its
    slots and scatters it: three whole frames, nothing handed back.  The
    reference hands the wide frame's datagrams back to the slow path and
    its fast path gives the two small frames only (recorded)."""
    rec = _Recorder()
    tx = transmit.Tx(mtu=9000, device="cpu")
    sizes = ((64, 32), (384, 360), (64, 32))
    sent = [_uyvy(w, h, seed=i) for i, (w, h) in enumerate(sizes)]
    for i, ((w, h), data) in enumerate(zip(sizes, sent)):
        tx.send_video(rec, VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [torch.as_tensor(data)], 1.0 + i))
    port_no = free_port_pair()
    if side == "port":
        session = RtpSession(addr=None, rx_port=port_no, tx_port=0)
        fast = FastVideoRx(session, VideoRxState(device="cpu"))
    else:
        session = RefSession(addr=None, rx_port=port_no, tx_port=0)
        fast = RefFastRx(session, RefRxState())
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    frames, handed_back = [], []
    try:
        for pkt in rec.packets:
            sock.sendto(pkt, ("127.0.0.1", port_no))
        time.sleep(0.2)  # every datagram waits in the socket: one batch
        deadline = time.monotonic() + 1.5
        while len(frames) < len(sent) and time.monotonic() < deadline:
            handed_back += fast.drain(timeout=0.01)
            frames += fast.poll(time.monotonic() + 10, 0.0)
    finally:
        sock.close()
        fast.close()
        session.close()
    wide = len(rec.packets) - 2
    if side == "port":
        assert handed_back == [] and len(frames) == 3
        for f, data in zip(frames, sent):
            assert np.array_equal(_host(f.data).reshape(data.shape), data)
    else:
        assert len(handed_back) == wide and len(frames) == 2
        for f, data in zip(frames, (sent[0], sent[2])):
            assert np.array_equal(_host(f.data).reshape(data.shape), data)


# ---------------------------------------------------------------------------
# live sessions, both ways
# ---------------------------------------------------------------------------


def _lossy(session, seed, k, m, per_frame=1):
    """Drop ``per_frame`` seeded data packets of every frame out of a
    session's batches before they reach the receiver (LDGM recovers them)."""
    rng = random.Random(seed)
    send = session.send_batch

    def send_batch(ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns=0):
        data_end = np.asarray(data).size * k // (k + m)
        idx = [i for i in range(len(sizes)) if offsets[i] + sizes[i] <= data_end]
        lost = set(rng.sample(idx, min(per_frame, len(idx))))
        keep = [i for i in range(len(sizes)) if i not in lost]
        return send(ts, pt, hdrs[keep], data, np.asarray(offsets)[keep], np.asarray(sizes)[keep],
                    m_last, pace_ns)

    session.send_batch = send_batch


def _session(direction, compress, fec, n_frames=3):
    """One live session; returns the displayed frames as host arrays."""
    port_no = free_port_pair()
    shown = []
    spec = "testcard:s=128x64:f=60:c=UYVY:still=1"
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
    # a small MTU: a few LDGM symbols per packet, so a lost packet is recoverable
    if direction == "port->ref":
        sender = VideoSender(spec, "127.0.0.1", compress_spec=compress, fec_spec=fec, tx_port=port_no,
                             mtu=400, frame_limit=n_frames + 6, device="cpu")
    else:
        sender = RefSender(spec, "127.0.0.1", compress_spec=compress, fec_spec=fec, tx_port=port_no,
                           mtu=400, frame_limit=n_frames + 6)
    if fec.startswith("ldgm"):
        k, m = (int(x) for x in fec.split(":")[1:3])
        _lossy(sender.session, 7, k, m)
    sender.run()
    t.join(timeout=15)
    assert not t.is_alive(), "the receiver did not stop"
    if direction == "ref->port" and fec.startswith("ldgm"):
        # the port's peel ran on lost symbols and brought every frame back
        assert recv.rx_state.fec_recovered >= len(shown) > 0
    return shown


@pytest.mark.parametrize("compress,fec", [("none", "none"), ("jpeg:80", "none"), ("jpeg:80", "ldgm:32:16:5")],
                         ids=["none", "jpeg", "jpeg-ldgm-loss"])
def test_live_session_both_ways(compress, fec):
    frames = {}
    for direction in ("port->ref", "ref->port"):
        for _attempt in range(3):
            got = _session(direction, compress, fec)
            if len(got) >= 2:
                break
        assert len(got) >= 2, f"{direction}: {len(got)} frames displayed in 3 attempts"
        frames[direction] = got
    first = frames["port->ref"][0]
    for got in frames.values():
        for f in got:
            assert np.array_equal(f, first)
    if compress == "none":
        from ultragrid_tpu_torch.utils.pattern import generate_pattern

        assert np.array_equal(first, generate_pattern(128, 64, Codec.UYVY, "bars", device="cpu").numpy())


def test_receiver_fast_path_off_and_framebuffers_display_owned():
    """``--param vrx-fast=off`` takes the Python pbuf path; uncompressed
    frames land in display-owned framebuffers (ref
    tests/test_pipeline.py:470-517): put_frame receives the very frames
    get_frame handed out."""
    for mode in ("off", "auto"):
        params.set_commandline_param("vrx-fast", mode)
        port_no = free_port_pair()
        recv = VideoReceiver("dummy", rx_port=port_no, frame_limit=3, timeout=20.0, device="cpu")
        handed, shown = [], []
        orig_get, orig_put = recv.display.get_frame, recv.display.put_frame

        def get():
            f = orig_get()
            handed.append(id(f))
            return f

        def put(frame, blocking=True):
            if frame is not None:
                shown.append((id(frame), bool(frame.callbacks.get("display_owned"))))
            orig_put(frame, blocking)

        recv.display.get_frame, recv.display.put_frame = get, put
        t = threading.Thread(target=recv.run, daemon=True)
        t.start()
        time.sleep(0.2)
        VideoSender("testcard:s=128x96:f=60:c=UYVY:still=1", "127.0.0.1", tx_port=port_no,
                    frame_limit=12, device="cpu").run()
        t.join(timeout=20)
        assert not t.is_alive()
        assert recv.frames_displayed >= 3
        assert shown and all(owned for _, owned in shown)
        assert all(fid in handed for fid, _ in shown)
        assert (recv._fast is None) == (mode == "off")


def test_receiver_refuses_an_unknown_fast_path_mode():
    params.set_commandline_param("vrx-fast", "maybe")
    recv = VideoReceiver("dummy", rx_port=0, device="cpu")
    try:
        with pytest.raises(ValueError, match="vrx-fast=maybe"):
            recv.run()
    finally:
        recv.session.close()


@pytest.mark.parametrize("package", ["port", "reference"])
def test_async_wait_returns_once_every_packet_is_handed_to_the_socket(package):
    """After ``async_wait`` every packet sent before it is in the receiving
    socket on 127.0.0.1 (the reference waits for its send thread; the port
    sends from the caller's thread and returns at once)."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    sess = (RtpSession if package == "port" else RefSession)(addr="127.0.0.1", rx_port=0,
                                                             tx_port=rx.getsockname()[1])
    try:
        for i in range(5):
            sess.send_data_hdr(i, 96, True, b"", bytes([i]) * 10)
        sess.async_wait()
        rx.setblocking(False)
        got = [rx.recv(2048) for _ in range(5)]
        assert [g[12:] for g in got] == [bytes([i]) * 10 for i in range(5)]
    finally:
        sess.close()
        rx.close()
