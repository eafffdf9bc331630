"""The port's standards-mode modules against the JAX package's, on the CPU.

RFC 2435 (``net/rtpdec_jpeg.py``): ``make_tables`` for every Q below 128;
``packetize`` and ``JpegDepacketizer`` over the cases of the reference's
``tests/test_net.py`` (in order, reversed, through a localhost RTP pair)
and over restart intervals 0, 1 and 7 and 4:2:0 (type 1); the 4K refusal.
``Tx(rfc2435=True)`` packets and ``Tx.send_audio_standard`` packets (PCMU,
8 kHz and 48 kHz, mono and stereo: the reference's sender sends PCMU only)
against the reference ``Tx``'s; the G.711 decode of PT 0 (PCMU) and PT 8
(PCMA) in ``AudioRxState``; ``VideoRxState`` on PT 26 and PT 96; RFC 6184
(``net/rtpdec_h264.py``) over the port's own IDR and P access units (FU-A,
STAP-A, SPS and PPS put back in); ``make_sdp``, ``parse_sdp`` and the
``RtspServer``'s replies with the Session id masked out.  Equal means
byte-equal; the decodes are the port's CPU decoder, held to the reference
in ``test_torch_decode.py``.  Inputs come from numpy seeds.
"""

import io
import re
import socket
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ultragrid_tpu.audio.types import AudioDesc as RefAudioDesc  # noqa: E402
from ultragrid_tpu.audio.types import AudioFrame as RefAudioFrame  # noqa: E402
from ultragrid_tpu.net import audio_rx as ref_audio_rx  # noqa: E402
from ultragrid_tpu.net import rtpdec_h264 as ref_h264  # noqa: E402
from ultragrid_tpu.net import rtpdec_jpeg as ref_jpeg  # noqa: E402
from ultragrid_tpu.net import rtsp as ref_rtsp  # noqa: E402
from ultragrid_tpu.net import rtsp_client as ref_client  # noqa: E402
from ultragrid_tpu.net import transmit as ref_tx  # noqa: E402
from ultragrid_tpu.net import video_rx as ref_video_rx  # noqa: E402
from ultragrid_tpu.net.pbuf import PbufNode as RefNode  # noqa: E402
from ultragrid_tpu.net.rtp import RtpPacket as RefPacket  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402
from ultragrid_tpu.utils import sdp as ref_sdp  # noqa: E402

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame  # noqa: E402
from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress  # noqa: E402
from ultragrid_tpu_torch.net import audio_rx, rtpdec_h264, rtpdec_jpeg, rtsp, rtsp_client, transmit, video_rx  # noqa: E402
from ultragrid_tpu_torch.net import rtp_types as rt  # noqa: E402
from ultragrid_tpu_torch.net.pbuf import PbufNode  # noqa: E402
from ultragrid_tpu_torch.net.rtp import RtpPacket  # noqa: E402
from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice, Intra16EncoderDevice  # noqa: E402
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder, _parse_headers  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import sdp  # noqa: E402


def _uyvy(w, h, seed):
    """A smooth seeded picture with some noise (limited range)."""
    rng = np.random.default_rng(seed)
    base = np.linspace(40, 200, 2 * w)[None, :] + np.linspace(0, 30, h)[:, None]
    return (base + rng.normal(0, 6, (h, 2 * w))).clip(16, 235).astype(np.uint8)


def _port_jpeg(w, h, seed, quality=80, ri=None, sub=None):
    enc = JpegEncoder(w, h, quality=quality, restart_interval=ri, subsampling=sub)
    return enc.encode(_uyvy(w, h, seed), device="cpu").tobytes()


def _pil_jpeg(w, h, seed, subsampling):
    """libjpeg's file (no restart interval, standard Huffman tables)."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(seed)
    rgb = (np.linspace(0, 255, w)[None, :, None] + rng.normal(0, 10, (h, w, 3))).clip(0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "JPEG", quality=85, subsampling=subsampling)
    return buf.getvalue()


def _decode(jpeg: bytes, codec=Codec.UYVY):
    hdr = _parse_headers(jpeg)
    frame = VideoFrame(VideoDesc(hdr["w"], hdr["h"], Codec.JPEG, 30.0), [np.frombuffer(jpeg, np.uint8)])
    return JpegDecompress(device="cpu").decompress(frame, codec).data


def _feed(dep, payloads, order):
    out = None
    for i in order:
        got = dep.feed(payloads[i], marker=i == len(payloads) - 1)
        if got is not None:
            out = got
    return out


# ---------------------------------------------------------------------------
# RFC 2435
# ---------------------------------------------------------------------------


def test_make_tables_equal_reference_for_every_q():
    for q in range(1, 128):
        assert rtpdec_jpeg.make_tables(q) == ref_jpeg.make_tables(q), q
    assert rtpdec_jpeg.make_tables(50)[0][0] == 16 and rtpdec_jpeg.make_tables(50)[1][0] == 17


def test_make_jpeg_header_equals_reference():
    lq, cq = rtpdec_jpeg.make_tables(75)
    for jtype, dri in ((0, 0), (1, 0), (0, 7)):
        assert (rtpdec_jpeg.make_jpeg_header(320, 240, jtype, lq, cq, dri)
                == ref_jpeg.make_jpeg_header(320, 240, jtype, lq, cq, dri))


_FILES = {
    # the reference's tests/test_net.py cases: 320x240 q85 at MTU 500, in
    # order; 256x192 q70 at MTU 400, reversed
    "320x240-q85": (lambda: _port_jpeg(320, 240, 1, quality=85), 500, "forward"),
    "256x192-q70-reversed": (lambda: _port_jpeg(256, 192, 2, quality=70), 400, "reverse"),
    "ri0-422": (lambda: _pil_jpeg(320, 240, 3, subsampling=1), 700, "forward"),
    "ri1": (lambda: _port_jpeg(320, 240, 4, ri=1), 600, "forward"),
    "ri7": (lambda: _port_jpeg(320, 240, 5, ri=7), 600, "shuffled"),
    "420-type1-port": (lambda: _port_jpeg(320, 240, 6, sub="420"), 800, "forward"),
    "420-type1-ri0": (lambda: _pil_jpeg(320, 240, 7, subsampling=2), 800, "reverse"),
}


@pytest.mark.parametrize("case", list(_FILES))
def test_packetize_and_depacketize_equal_reference(case):
    make, mtu, order = _FILES[case]
    jpeg = make()
    payloads = rtpdec_jpeg.packetize(jpeg, mtu_payload=mtu)
    assert payloads == ref_jpeg.packetize(jpeg, mtu_payload=mtu)
    assert len(payloads) > 1 and all(len(p) <= mtu for p in payloads)
    jtype = payloads[0][4]
    hdr = _parse_headers(jpeg)
    assert jtype & 1 == (0 if hdr["scan"][0]["v"] == 1 else 1)
    assert bool(jtype & rtpdec_jpeg.RTP_TYPE_RST_BIT) == bool(hdr["ri"])
    idx = list(range(len(payloads)))
    if order == "reverse":
        idx.reverse()
    elif order == "shuffled":
        np.random.default_rng(8).shuffle(idx)
    port_dep, ref_dep = rtpdec_jpeg.JpegDepacketizer(), ref_jpeg.JpegDepacketizer()
    if order == "forward":  # nothing before the marker completes a frame
        for i, p in enumerate(payloads[:-1]):
            assert port_dep.feed(p, marker=False) is None
            assert ref_dep.feed(p, marker=False) is None
        out, ref_out = port_dep.feed(payloads[-1], True), ref_dep.feed(payloads[-1], True)
    else:
        out, ref_out = _feed(port_dep, payloads, idx), _feed(ref_dep, payloads, idx)
    assert out is not None and out == ref_out
    # the rebuilt file decodes to the original's pixels
    assert torch.equal(_decode(out), _decode(jpeg))


def test_depacketizer_incomplete_and_q_below_128_equal_reference():
    jpeg = _port_jpeg(256, 192, 9, quality=60)
    payloads = rtpdec_jpeg.packetize(jpeg, mtu_payload=300)
    # a gap: the marker arrives but a middle fragment never does
    for dep in (rtpdec_jpeg.JpegDepacketizer(), ref_jpeg.JpegDepacketizer()):
        assert _feed(dep, payloads, [i for i in range(len(payloads)) if i != 2]) is None
    # Q < 128: no table header, tables from make_tables(Q)
    q = 50
    body = payloads[0][8 + 4 + 128:]
    first = bytearray(payloads[0][:8]) + body
    first[5] = q
    rest = [bytearray(p) for p in payloads[1:]]
    for p in rest:
        p[5] = q
    stream = [bytes(first)] + [bytes(p) for p in rest]
    out = _feed(rtpdec_jpeg.JpegDepacketizer(), stream, range(len(stream)))
    assert out == _feed(ref_jpeg.JpegDepacketizer(), stream, range(len(stream)))
    assert _parse_headers(out)["qtabs"][0][0] == 16


def test_packetize_refuses_4k_in_both_packages():
    lq, cq = rtpdec_jpeg.make_tables(80)
    jpeg = rtpdec_jpeg.make_jpeg_header(3840, 2160, 0, lq, cq, 0) + b"\x12\x34" + b"\xff\xd9"
    for pkt in (rtpdec_jpeg.packetize, ref_jpeg.packetize):
        with pytest.raises(ValueError, match="2040"):
            pkt(jpeg)


class _HdrRecorder:
    """Stands in for an RtpSession: records each send_data_hdr call as the
    datagram it would send (seq from 0, a fixed ssrc)."""

    def __init__(self):
        self.packets = []

    def send_data_hdr(self, ts, pt, m, payload_hdr, data):
        hdr = struct.pack("!BBHII", 0x80, (0x80 if m else 0) | pt, len(self.packets) & 0xFFFF, ts & 0xFFFFFFFF, 7)
        self.packets.append(hdr + bytes(payload_hdr) + bytes(data))


@pytest.mark.parametrize("mtu", [1500, 600])
def test_tx_rfc2435_packets_equal_reference(mtu):
    jpeg = np.frombuffer(_port_jpeg(320, 240, 10), np.uint8)
    port_rec, ref_rec = _HdrRecorder(), _HdrRecorder()
    port = transmit.Tx(mtu=mtu, rfc2435=True, device="cpu")
    ref = ref_tx.Tx(mtu=mtu, rfc2435=True)
    for i in range(2):
        ts = 3.0 + i / 30
        n = port.send_video(port_rec, VideoFrame(VideoDesc(320, 240, Codec.JPEG, 30.0), [jpeg], timestamp=ts))
        ref.send_video(ref_rec, RefFrame(RefDesc(320, 240, RefCodec.JPEG, 30.0), [jpeg], timestamp=ts))
        assert n == len(rtpdec_jpeg.packetize(jpeg.tobytes(), mtu - 40))
    assert port_rec.packets == ref_rec.packets
    assert {p[1] & 0x7F for p in port_rec.packets} == {rt.PT_JPEG}
    assert port.buffer == ref.buffer == 2


def _audio(channels, rate, nsamples, seed):
    rng = np.random.default_rng(seed)
    pcm = (rng.normal(0, 4000, (channels, nsamples))).clip(-32768, 32767).astype("<i2")
    return [np.frombuffer(c.tobytes(), np.uint8) for c in pcm]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate", [8000, 48000])
def test_send_audio_standard_pcmu_equals_reference(rate, channels):
    chans = _audio(channels, rate, rate // 25, seed=rate + channels)
    port = AudioFrame(AudioDesc(bps=2, sample_rate=rate, ch_count=channels, codec="PCM"), chans)
    ref = RefAudioFrame(RefAudioDesc(bps=2, sample_rate=rate, ch_count=channels, codec="PCM"), chans)
    port.timestamp = ref.timestamp = 12.5
    port_rec, ref_rec = _HdrRecorder(), _HdrRecorder()
    n = transmit.Tx(device="cpu").send_audio_standard(port_rec, port)
    assert n == ref_tx.Tx().send_audio_standard(ref_rec, ref)
    assert port_rec.packets == ref_rec.packets
    assert n == 2  # 40 ms of audio, 20 ms a packet
    assert all(p[1] & 0x7F == 0 and len(p) == 12 + 160 * channels for p in port_rec.packets)


@pytest.mark.parametrize("pt,codec", [(0, "ulaw"), (8, "alaw")])
def test_g711_decode_in_audio_rx_equals_reference(pt, codec):
    raw = np.random.default_rng(pt).integers(0, 256, 480, dtype=np.uint8).tobytes()
    chunks = [raw[i:i + 160] for i in range(0, len(raw), 160)]
    node = PbufNode(ts=800, arrival=0.0, playout_delay=0.0)
    ref_node = RefNode(ts=800, arrival=0.0, playout_delay=0.0)
    for seq in (2, 0, 1):  # out of order: the decoder sorts by seq
        node.packets.append(RtpPacket(pt, seq, 800, 5, False, chunks[seq], 0.0))
        ref_node.packets.append(RefPacket(pt, seq, 800, 5, False, chunks[seq], 0.0))
    out = audio_rx.AudioRxState().decode_frame(node)
    ref = ref_audio_rx.AudioRxState().decode_frame(ref_node)
    assert (out.desc.sample_rate, out.desc.ch_count, out.desc.bps) == (8000, 1, ref.desc.bps)
    assert np.array_equal(np.asarray(out.channels[0]), np.asarray(ref.channels[0]))
    assert np.asarray(out.channels[0]).size == 480 * ref.desc.bps


def _nodes(datagrams):
    """RTP datagrams -> (port node, reference node) holding their packets."""
    node, ref_node = None, None
    for d in datagrams:
        b1 = d[1]
        seq, ts, ssrc = struct.unpack("!HII", d[2:12])
        args = (b1 & 0x7F, seq, ts, ssrc, bool(b1 & 0x80), d[12:], 0.0)
        if node is None:
            node = PbufNode(ts=ts, arrival=0.0, playout_delay=0.0)
            ref_node = RefNode(ts=ts, arrival=0.0, playout_delay=0.0)
        node.packets.append(RtpPacket(*args))
        ref_node.packets.append(RefPacket(*args))
    return node, ref_node


def test_video_rx_pt26_equals_reference():
    jpeg = np.frombuffer(_port_jpeg(320, 240, 11), np.uint8)
    rec = _HdrRecorder()
    ref_tx.Tx(mtu=700, rfc2435=True).send_video(rec, RefFrame(RefDesc(320, 240, RefCodec.JPEG, 30.0), [jpeg],
                                                            timestamp=1.0))
    node, ref_node = _nodes(rec.packets[::-1])  # arrival order does not matter
    state = video_rx.VideoRxState(device="cpu")
    out = state.reassemble(node)
    ref = ref_video_rx.VideoRxState().reassemble(ref_node)
    assert out.desc.color_spec == Codec.JPEG and (out.desc.width, out.desc.height) == (320, 240)
    assert bytes(np.asarray(out.data)) == bytes(np.asarray(ref.data))
    assert out.timestamp == ref.timestamp == 1.0
    assert torch.equal(_decode(bytes(np.asarray(out.data))), _decode(jpeg.tobytes()))
    assert state.frames_ok == 1
    # the tail lost: as in the reference, the last packet that came is taken
    # for the marker and the file is cut short there
    node, ref_node = _nodes(rec.packets[:-2])
    cut, ref_cut = state.reassemble(node), ref_video_rx.VideoRxState().reassemble(ref_node)
    assert bytes(np.asarray(cut.data)) == bytes(np.asarray(ref_cut.data))
    assert cut.data.size < out.data.size
    # a gap in the middle: nothing comes out, and the frame is counted
    node, ref_node = _nodes(rec.packets[:2] + rec.packets[3:])
    assert state.reassemble(node) is None and ref_video_rx.VideoRxState().reassemble(ref_node) is None
    assert state.frames_missing_data == 1


def _h264_aus(n=4):
    enc = InterEncoderDevice(64, 48, qp=26, gop=3, device="cpu")
    aus = [enc.encode_uyvy(_uyvy(64, 48, 20 + i)) for i in range(n)]
    idr = Intra16EncoderDevice(64, 48, qp=26, device="cpu").encode_uyvy(_uyvy(64, 48, 30))
    return aus, idr


def _nal_units(au):
    return [n for n in rtpdec_h264.packetize(au, mtu_payload=1 << 30)]


def test_video_rx_pt96_equals_reference():
    aus, _ = _h264_aus()
    state, ref_state = video_rx.VideoRxState(device="cpu"), ref_video_rx.VideoRxState()
    for i, au in enumerate(aus):
        payloads = rtpdec_h264.packetize(au, mtu_payload=200)
        rec = _HdrRecorder()
        for j, p in enumerate(payloads):
            rec.send_data_hdr(i * 3000, rt.PT_H264, j == len(payloads) - 1, b"", p)
        node, ref_node = _nodes(rec.packets)
        out, ref = state.reassemble(node), ref_state.reassemble(ref_node)
        assert out.desc.color_spec == Codec.H264
        assert bytes(np.asarray(out.data)) == bytes(np.asarray(ref.data)) == au
        assert out.callbacks["frame_type"] == ref.callbacks["frame_type"]


def test_rtpdec_h264_fu_a_stap_a_and_parameter_sets_equal_reference():
    aus, idr = _h264_aus()
    for au in aus + [idr]:
        for mtu in (1400, 60):  # single NAL units; FU-A fragments
            payloads = rtpdec_h264.packetize(au, mtu_payload=mtu)
            assert payloads == ref_h264.packetize(au, mtu_payload=mtu)
            if mtu == 60:
                assert any(p[0] & 0x1F == rtpdec_h264.NAL_FU_A for p in payloads)
            outs = []
            for dep in (rtpdec_h264.H264Depacketizer(), ref_h264.H264Depacketizer()):
                outs.append(_feed(dep, payloads, range(len(payloads))))
            assert outs[0] == outs[1] == au
    # STAP-A: SPS and PPS aggregated in one packet, then the slice
    nals = _nal_units(idr)
    types = [n[0] & 0x1F for n in nals]
    assert types[:2] == [rtpdec_h264.NAL_SPS, rtpdec_h264.NAL_PPS]
    stap = bytes([0x78]) + b"".join(len(n).to_bytes(2, "big") + n for n in nals[:2])
    stream = [stap] + nals[2:]
    outs = [_feed(dep, stream, range(len(stream)))
            for dep in (rtpdec_h264.H264Depacketizer(), ref_h264.H264Depacketizer())]
    assert outs[0] == outs[1] == idr
    # an IDR sent without its parameter sets: the depacketizer puts back
    # the ones it saw (or was given from sprop-parameter-sets)
    bare = nals[2:]
    for mod in (rtpdec_h264, ref_h264):
        dep = mod.H264Depacketizer()
        dep.sps, dep.pps = nals[0], nals[1]
        assert _feed(dep, bare, range(len(bare))) == idr
        assert dep.frame_type == mod.FRAME_BFRAME
    # a P access unit gets no parameter sets
    p_nals = _nal_units(aus[1])
    dep = rtpdec_h264.H264Depacketizer()
    dep.sps, dep.pps = nals[0], nals[1]
    assert _feed(dep, p_nals, range(len(p_nals))) == aus[1]


# ---------------------------------------------------------------------------
# SDP and RTSP
# ---------------------------------------------------------------------------

_STREAMS = [
    [("video", 5004, 26, "JPEG", 90000)],
    [("video", 6004, 96, "H264", 90000), ("audio", 6006, 0, "PCMU", 8000)],
]


@pytest.mark.parametrize("dest", ["127.0.0.1", "::1"])
@pytest.mark.parametrize("streams", _STREAMS, ids=["jpeg", "h264-pcmu"])
def test_make_sdp_and_parse_sdp_equal_reference(dest, streams):
    text = sdp.make_sdp(dest, streams, "x")
    assert text == ref_sdp.make_sdp(dest, streams, "x")
    # the code writes a=rtpmap for static payload types too
    assert text.count("a=rtpmap:") == len(streams)
    extra = "a=fmtp:96 packetization-mode=1;sprop-parameter-sets=Z0IAHpWoKA9k,aM48gA==\r\na=control:trackID=0\r\n"
    for t in (text, text + extra, "v=0\r\nm=audio 5006 RTP/AVP 8\r\nm=video 5004 RTP/AVP 26\r\n"):
        assert [vars(m) for m in rtsp_client.parse_sdp(t)] == [vars(m) for m in ref_client.parse_sdp(t)]


def test_sdp_http_server_serves_the_document():
    import urllib.request

    doc = sdp.make_sdp("127.0.0.1", _STREAMS[0])
    srv = sdp.SdpHttpServer(doc, port=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/ultragrid.sdp", timeout=5) as r:
            assert r.read().decode() == doc
            assert r.headers["Content-Type"] == "application/sdp"
    finally:
        srv.close()
    assert sdp.DEFAULT_SDP_HTTP_PORT == ref_sdp.DEFAULT_SDP_HTTP_PORT == rtsp.DEFAULT_RTSP_PORT == 8554


def _rtsp_dialogue(port):
    """A client's requests, bad ones included; the raw replies."""
    base = f"rtsp://127.0.0.1:{port}/ug"
    reqs = [
        f"OPTIONS {base} RTSP/1.0\r\nCSeq: 1\r\n\r\n",
        f"DESCRIBE {base} RTSP/1.0\r\nCSeq: 2\r\nAccept: application/sdp\r\n\r\n",
        f"SETUP {base}/trackID=0 RTSP/1.0\r\nCSeq: 3\r\nTransport: RTP/AVP;multicast\r\n\r\n",
        f"SETUP {base}/trackID=0 RTSP/1.0\r\nCSeq: 4\r\nTransport: RTP/AVP;unicast;client_port=40000-40001\r\n\r\n",
        f"PLAY {base} RTSP/1.0\r\nCSeq: 5\r\nSession: BOGUS\r\n\r\n",
        f"PLAY {base} RTSP/1.0\r\nCSeq: 6\r\nSession: {{sid}}\r\nRange: npt=0-\r\n\r\n",
        f"PAUSE {base} RTSP/1.0\r\nCSeq: 7\r\nSession: {{sid}}\r\n\r\n",
        f"GET_PARAMETER {base} RTSP/1.0\r\nCSeq: 8\r\nContent-Length: 4\r\n\r\nabcd",
        f"TEARDOWN {base} RTSP/1.0\r\nCSeq: 9\r\nSession: {{sid}}\r\n\r\n",
    ]
    replies = []
    sid = ""
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        f = s.makefile("rwb")
        for req in reqs:
            f.write(req.replace("{sid}", sid).encode())
            f.flush()
            lines = []
            while True:
                line = f.readline()
                lines.append(line)
                if line in (b"\r\n", b""):
                    break
            head = b"".join(lines).decode()
            m = re.search(r"Content-Length: (\d+)", head)
            body = f.read(int(m.group(1))).decode() if m else ""
            m = re.search(r"Session: ([0-9A-F]{8})", head)
            if m:
                sid = m.group(1)
            replies.append(re.sub(r"[0-9A-F]{8}", "<sid>", head) + body)
    return replies


def test_rtsp_server_replies_equal_reference():
    calls = {"port": [], "ref": []}
    servers = {
        "port": rtsp.RtspServer(_STREAMS[0], port=0, on_play=lambda a, p: calls["port"].append(("play", a, p)),
                                on_teardown=lambda a, p: calls["port"].append(("stop", a, p))),
        "ref": ref_rtsp.RtspServer(_STREAMS[0], port=0, on_play=lambda a, p: calls["ref"].append(("play", a, p)),
                                   on_teardown=lambda a, p: calls["ref"].append(("stop", a, p))),
    }
    try:
        got = {k: _rtsp_dialogue(srv.port) for k, srv in servers.items()}
    finally:
        for srv in servers.values():
            srv.close()
    # the Content-Base names each server's own port
    got["ref"] = [r.replace(str(servers["ref"].port), str(servers["port"].port)) for r in got["ref"]]
    assert got["port"] == got["ref"]
    assert [r.split("\r\n")[0] for r in got["port"]] == [
        "RTSP/1.0 200 OK", "RTSP/1.0 200 OK", "RTSP/1.0 461 Unsupported Transport", "RTSP/1.0 200 OK",
        "RTSP/1.0 454 Session Not Found", "RTSP/1.0 200 OK", "RTSP/1.0 200 OK", "RTSP/1.0 501 Not Implemented",
        "RTSP/1.0 200 OK"]
    assert "m=video 5004 RTP/AVP 26" in got["port"][1]
    assert calls["port"] == calls["ref"] == [("play", "127.0.0.1", 40000), ("stop", "127.0.0.1", 40000),
                                             ("stop", "127.0.0.1", 40000)]


def test_rtsp_client_against_both_servers():
    for cls in (rtsp.RtspServer, ref_rtsp.RtspServer):
        played = []
        srv = cls(_STREAMS[1], port=0, on_play=lambda a, p: played.append(p))
        try:
            port_c = rtsp_client.RtspClient(f"rtsp://127.0.0.1:{srv.port}/ug")
            medias = port_c.describe()
            assert [(m.kind, m.payload_type, m.encoding) for m in medias] == [("video", 96, "H264"),
                                                                             ("audio", 0, "PCMU")]
            port_c.setup(medias[0], 41000)
            assert re.fullmatch(r"[0-9A-F]{8}", port_c.session_id)
            port_c.play(keepalive_interval=0)
            port_c.teardown()
            assert played == [41000]
        finally:
            srv.close()
    with pytest.raises(ValueError, match="rtsp://"):
        rtsp_client.RtspClient("http://127.0.0.1/x")
