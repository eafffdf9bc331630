"""The port's libavcodec modules against the JAX package's, on the CPU.

Every case of ``tests/test_lavc.py`` (its two skip conditions kept: the
module imports, and the shim builds), run across the two packages: the same
seeded frames through the reference's ``LavcCompress`` / ``LavcDecompress``,
audio codecs, file capture and mpegts and the port's.  Both link the same
libavcodec, so the tolerance is none: packets and decoded frames are equal
byte for byte.  The port builds its own copy of the shim with the
reference's decoder fault F1 repaired (one decoding thread, no drain: the
reference's decoder holds frames back and never gives a stream's tail), so
where the reference gives None (F1) the port's frame is held to the
reference test's own gate and to the own H.264 decoder; a libx264 ``bf=3``
stream shows both behaviours side by side.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference on the CPU)

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

from chip_smoke import free_port_pair  # noqa: E402

lavc = pytest.importorskip("ultragrid_tpu_torch.modules.lavc")
ref_lavc = pytest.importorskip("ultragrid_tpu.modules.lavc")
if not lavc.lavc_available():
    pytest.skip("libavcodec shim unavailable", allow_module_level=True)

W, H = 320, 240


def _bars(w=W, h=H, codec=Codec.UYVY, name="bars"):
    return generate_pattern(w, h, codec, name, device="cpu").numpy()


def _frames(orig, codec=Codec.UYVY, w=W, h=H, c=Codec.UYVY):
    return (VideoFrame(VideoDesc(w, h, c, 30.0), [torch.as_tensor(orig)]),
            RefFrame(RefDesc(w, h, RefCodec(int(c)), 30.0), [orig]))


def _host(data):
    return data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


def _err(got, orig):
    return np.abs(_host(got).astype(int) - orig.astype(int)).mean()


@pytest.mark.parametrize("codec", ["H.264", "VP8", "VP9", "MJPEG", "prores", "CFHD", "FFV1"])
def test_lavc_video_roundtrip(codec):
    """One frame through each package's encoder (equal packets) and decoder:
    the reference's decode where it gives one (MJPEG, FFV1), equal byte for
    byte; where F1 holds its frame back (the reference's None), the port's
    is within the reference test's gate (FFV1: lossless)."""
    cfg = f"codec={codec}:bitrate=3M" if codec != "FFV1" else "codec=FFV1"
    orig = _bars()
    frame, ref_frame = _frames(orig)
    enc, ref_enc = lavc.LavcCompress(cfg, device="cpu"), ref_lavc.LavcCompress(cfg)
    out, ref_out = enc.compress(frame), ref_enc.compress(ref_frame)
    assert out is not None and ref_out is not None
    assert np.array_equal(_host(out.data), np.asarray(ref_out.data))
    assert out.callbacks.get("keyframe") == ref_out.callbacks.get("keyframe")
    dec, ref_dec = lavc.LavcDecompress(device="cpu"), ref_lavc.LavcDecompress()
    back = dec.decompress(out, Codec.UYVY)
    ref_back = ref_dec.decompress(ref_out, RefCodec.UYVY)
    assert back is not None and back.data.device.type == "cpu"
    if ref_back is not None:
        assert np.array_equal(_host(back.data), np.asarray(ref_back.data))
    assert _err(back.data, orig) == 0.0 if codec == "FFV1" else _err(back.data, orig) < 4.0
    for m in (enc, ref_enc, dec, ref_dec):
        m.done()


def test_lavc_ffv1_lossless():
    orig = _bars()
    frame, _ = _frames(orig)
    enc = lavc.LavcCompress("codec=FFV1", device="cpu")
    back = lavc.LavcDecompress(device="cpu").decompress(enc.compress(frame), Codec.UYVY)
    assert np.array_equal(_host(back.data), orig)
    enc.done()


def test_h264_rfc6184_to_displayable_frame():
    """PT 96 H.264 packetized per RFC 6184, depacketized through each
    package's receive path and decoded by the decoder ``decompress_init``
    picks: equal frames, within the reference test's gate of the source."""
    from ultragrid_tpu.modules.video_decompress import decompress_init as ref_init
    from ultragrid_tpu.net.rtpdec_h264 import H264Depacketizer as RefDepack

    from ultragrid_tpu_torch.modules.video_decompress import decompress_init
    from ultragrid_tpu_torch.net.rtpdec_h264 import H264Depacketizer, packetize

    orig = _bars()
    frame, _ = _frames(orig)
    enc = lavc.LavcCompress("codec=H.264:bitrate=2M", device="cpu")
    au = bytes(_host(enc.compress(frame).data))
    enc.done()
    pkts = packetize(au, mtu_payload=800)
    shown = []
    for depack, init, mk, uyvy in ((H264Depacketizer(), lambda: decompress_init(Codec.H264, [Codec.UYVY, Codec.RGB],
                                                                                    device="cpu"),
                                    lambda d: VideoFrame(VideoDesc(W, H, Codec.H264, 30.0), [np.frombuffer(d, np.uint8)]),
                                    Codec.UYVY),
                                   (RefDepack(), lambda: ref_init(RefCodec.H264, [RefCodec.UYVY, RefCodec.RGB]),
                                    lambda d: RefFrame(RefDesc(W, H, RefCodec.H264, 30.0), [np.frombuffer(d, np.uint8)]),
                                    RefCodec.UYVY)):
        got = None
        for i, p in enumerate(pkts):
            got = depack.feed(p, marker=i == len(pkts) - 1)
        assert got is not None
        shown.append(got)
        decomp, out_codec = init()
        assert type(decomp).__name__ == "OwnH264Decompress" and int(out_codec) == int(uyvy)
        shown.append(_host(decomp.decompress(mk(got), out_codec).data))
        decomp.done()
    port_au, port_img, ref_au, ref_img = shown
    assert port_au == ref_au
    assert np.array_equal(port_img, ref_img) and _err(port_img, orig) < 4.0


def test_lavc_end_to_end_rtp_h264():
    """The port's session with ``-c libavcodec:codec=H.264``: the last shown
    frame within the reference test's gate of the still testcard."""
    from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver
    from ultragrid_tpu_torch.pipeline.sender import VideoSender

    port = free_port_pair()
    received = []
    recv = VideoReceiver("dummy", rx_port=port, frame_limit=2, timeout=45.0, device="cpu")
    put = recv.display.put_frame

    def keep(frame, blocking=True):
        if frame is not None:
            received.append(frame)
        put(frame, blocking)

    recv.display.put_frame = keep
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    time.sleep(0.2)
    VideoSender("testcard:s=320x240:f=30:c=UYVY:still=1", "127.0.0.1",
                compress_spec="libavcodec:codec=H.264:bitrate=2M", tx_port=port, frame_limit=6, device="cpu").run()
    t.join(timeout=30)
    assert received, "no H.264 frames displayed"
    orig = _bars()
    assert _host(received[-1].data).shape == orig.shape and _err(received[-1].data, orig) < 4.0


@pytest.mark.parametrize("codec_name", ["Opus", "G722", "speex"])
def test_lavc_audio_rtp_end_to_end(codec_name):
    """Opus / G.722 / Speex over the native audio RTP path: the port's Tx
    and AudioRxState, each decoded frame equal to the reference codec's
    decode of the same packets, and with energy (the testcard's sine)."""
    from ultragrid_tpu.audio.codecs import _CODECS as REF_CODECS

    from ultragrid_tpu_torch.audio.capture import TestcardAudioCapture
    from ultragrid_tpu_torch.audio.codecs import get_audio_codec
    from ultragrid_tpu_torch.net.audio_rx import AudioRxState
    from ultragrid_tpu_torch.net.pbuf import PlayoutBuffer
    from ultragrid_tpu_torch.net.rtp import RtpSession
    from ultragrid_tpu_torch.net.transmit import Tx

    port = free_port_pair()
    rx = RtpSession(addr=None, rx_port=port, tx_port=0)
    tx_sess = RtpSession(addr="127.0.0.1", rx_port=0, tx_port=port)
    tx = Tx(mtu=1500, device="cpu")
    cap = TestcardAudioCapture()
    codec = get_audio_codec(codec_name)
    ref_dec = REF_CODECS[codec_name]()
    state = AudioRxState()
    decoded = []
    try:
        for _cycle in range(3):
            comps = codec.compress_multi(cap.read(48000 // 25))
            if not comps:
                continue  # encoder latency on the first cycle
            for comp in comps:
                tx.send_audio(tx_sess, comp, codec_name)
            pbuf, nodes = PlayoutBuffer(), []
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and len(nodes) < len(comps):
                pkt = rx.recv(timeout=0.05)
                if pkt:
                    pbuf.insert(pkt)
                    if pkt.m:
                        nodes = list(pbuf.frames.values())
            assert len(nodes) == len(comps)
            for node, comp in zip(nodes, comps):
                out = state.decode_frame(node)
                assert out is not None and out.desc.codec == "PCM"
                want = ref_dec.decompress(comp)
                assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(out.channels, want.channels))
                decoded.append(out)
    finally:
        tx_sess.close()
        rx.close()
    assert decoded and float(np.abs(decoded[-1].samples_float()).mean()) > 0.01


def test_own_jpeg_validates_against_lavc_decoder():
    """The port's JPEG stream (restart markers, the split entropy coder,
    byte stuffing) decodes in libavcodec's mjpeg decoder through each
    package: equal frames, within 2 of the own decode on luma, and the
    reference test's gate of the source."""
    from ultragrid_tpu.ops.jpeg import JpegEncoder as RefJpegEncoder

    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder, decode_jpeg_to_frame

    orig = _bars()
    data = JpegEncoder(W, H, in_codec=Codec.UYVY, quality=90, restart_interval=4).encode(orig, device="cpu")
    assert np.array_equal(np.asarray(data), np.asarray(RefJpegEncoder(W, H, in_codec=RefCodec.UYVY, quality=90,
                                                                      restart_interval=4).encode(orig)))
    vf = VideoFrame(VideoDesc(W, H, Codec.JPEG, 30.0), [np.asarray(data)])
    back = lavc.LavcDecompress(device="cpu").decompress(vf, Codec.UYVY)
    ref_back = ref_lavc.LavcDecompress().decompress(RefFrame(RefDesc(W, H, RefCodec.JPEG, 30.0), [np.asarray(data)]),
                                                    RefCodec.UYVY)
    got = _host(back.data).astype(int)
    assert np.array_equal(got, np.asarray(ref_back.data).astype(int))
    ours = _host(decode_jpeg_to_frame(vf, Codec.UYVY, device="cpu").data).astype(int)
    assert np.abs(got[:, 1::2] - ours[:, 1::2]).max() <= 2
    assert np.abs(got[:, 1::2] - orig[:, 1::2].astype(int)).mean() < 0.5


def test_file_capture_any_container(tmp_path):
    """The file capture reads any container through libavformat: an H.264
    elementary stream gives each package the same frames, the port's on its
    device."""
    from ultragrid_tpu.modules.video_capture import initialize_video_capture as ref_init

    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture

    enc = lavc.LavcCompress("codec=H.264:bitrate=2M", device="cpu")
    path = tmp_path / "clip.h264"
    orig = _bars()
    with open(path, "wb") as f:
        for _ in range(5):
            f.write(bytes(_host(enc.compress(_frames(orig)[0]).data)))
    enc.done()
    got = []
    for cap in (initialize_video_capture(f"file:{path}", device="cpu"), ref_init(f"file:{path}")):
        assert (cap.desc.width, cap.desc.height) == (W, H)
        frames = []
        for _ in range(5):
            fr, _a = cap.grab()
            if fr is None:
                break
            frames.append(_host(fr.data).copy())
        cap.done()
        got.append(frames)
    assert len(got[0]) == len(got[1]) >= 3
    assert all(np.array_equal(a, b) for a, b in zip(*got))
    assert _err(got[0][-1], orig) < 4.0


def test_mpegts_rxtx_end_to_end():
    """H.264 in MPEG-TS over localhost UDP: the port's sender muxes, its
    receiver demuxes, decodes and shows frames on its device."""
    from ultragrid_tpu_torch.pipeline.mpegts import MpegTsReceiver, MpegTsSender

    port = free_port_pair()
    received = []
    # the demuxer probes until the stream's end or the UDP timeout, then reads
    # what it buffered: a short timeout keeps the test short
    recv = MpegTsReceiver("dummy", port=port, frame_limit=3, timeout=3.0, device="cpu")
    put = recv.display.put_frame

    def keep(frame, blocking=True):
        if frame is not None:
            received.append(frame)
        put(frame, blocking)

    recv.display.put_frame = keep
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    time.sleep(0.3)
    MpegTsSender("testcard:s=320x240:f=30:c=UYVY:still=1", "127.0.0.1", port, bitrate="2M", frame_limit=15,
                 device="cpu").run()
    t.join(timeout=25)
    assert len(received) >= 1, "no TS frames displayed"
    orig = _bars()
    assert received[-1].data.device.type == "cpu"
    assert _host(received[-1].data).shape == orig.shape and _err(received[-1].data, orig) < 4.0


def _bframe_content(w, h, n, seed=5):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, 2 * w), np.uint8)
    base = ((base[:, :-2].astype(np.int32) + base[:, 2:]) // 2).astype(np.uint8)
    base = np.pad(base, ((0, 0), (0, 2)), mode="edge")
    return [np.roll(base, 2 * i, axis=1) for i in range(n)]


def test_f1_bframe_stream_tail_port_against_reference():
    """F1 both ways: a libx264 ``bf=3`` stream through the reference's
    LavcDecompress loses frames (frame threads hold them, nothing drains);
    through the port's every frame comes back, with ``flush`` at its end,
    each equal to the port's own H.264 decoder's picture, in display order."""
    from ultragrid_tpu_torch.ops.h264_dec import StreamDecoder

    w, h, n = 176, 144, 12
    enc = lavc.LavcCompress("codec=H.264:encoder=libx264:qp=24:g=12:aq-mode=0:profile=high:bf=3", device="cpu")
    aus = []
    for f in _bframe_content(w, h, n):
        c = enc.compress(VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [torch.as_tensor(f)]))
        if c is not None:
            aus.append(bytes(_host(c.data)))
    enc.done()
    assert len(aus) >= 8
    dec, ref_dec, own = lavc.LavcDecompress(device="cpu"), ref_lavc.LavcDecompress(), StreamDecoder()
    port_out, ref_out, own_out = [], [], []
    for au in aus:
        got = dec.decompress(VideoFrame(VideoDesc(w, h, Codec.H264, 30.0), [np.frombuffer(au, np.uint8)]),
                             Codec.UYVY)
        if got is not None:
            port_out.append(_host(got.data))
        ref = ref_dec.decompress(RefFrame(RefDesc(w, h, RefCodec.H264, 30.0), [np.frombuffer(au, np.uint8)]),
                                 RefCodec.UYVY)
        if ref is not None:
            ref_out.append(np.asarray(ref.data))
        mine = own.decode_au(au)
        if mine is not None:
            own_out.append(mine)
    port_out += [_host(f.data) for f in dec.flush(Codec.UYVY)]
    own_out += own.flush()
    assert len(ref_out) < len(aus)  # the reference loses the stream's tail (F1)
    assert len(port_out) == len(own_out) == len(aus)
    for uy, (y, cb, cr) in zip(port_out, own_out):
        assert np.array_equal(uy[:, 1::2], y)
        assert np.array_equal(uy[0::2, 0::4], cb) and np.array_equal(uy[0::2, 2::4], cr)
    # what the reference does give is the port's, frame for frame
    for a, b in zip(ref_out, port_out):
        assert np.array_equal(a, b)
    dec.done()
    ref_dec.done()
