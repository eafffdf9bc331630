"""The port's audio modules against the JAX package's, on the CPU.

Every case of ``tests/test_audio.py``, run across the two packages: the same
inputs (made from a seed with numpy, or the testcard's sine) through the
reference's module and the port's copy.  The audio stages are host numpy in
both, so the tolerance is none: frames, codes, samples, stats lines and
packets are equal byte for byte, the float stages (resampler, gain, mixer,
echo canceller) included.  The RTP cases send with one package's ``Tx`` and
decode with the other's ``AudioRxState``, both ways, Reed-Solomon with a lost
packet included; the port's RS parity runs on the CPU (``device="cpu"``).
"""

import socket
import struct
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference on the CPU)

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.audio import aes67 as ref_aes67  # noqa: E402
from ultragrid_tpu.audio import capture as ref_capture  # noqa: E402
from ultragrid_tpu.audio import codecs as ref_codecs  # noqa: E402
from ultragrid_tpu.audio import echo as ref_echo  # noqa: E402
from ultragrid_tpu.audio import filters as ref_filters  # noqa: E402
from ultragrid_tpu.audio import midi_synth as ref_midi  # noqa: E402
from ultragrid_tpu.audio import playback as ref_playback  # noqa: E402
from ultragrid_tpu.audio import resampler as ref_resampler  # noqa: E402
from ultragrid_tpu.audio import types as ref_types  # noqa: E402
from ultragrid_tpu.audio import volume as ref_volume  # noqa: E402
from ultragrid_tpu.modules import registry as ref_registry  # noqa: E402
from ultragrid_tpu.net import audio_rx as ref_audio_rx  # noqa: E402
from ultragrid_tpu.net import pbuf as ref_pbuf  # noqa: E402
from ultragrid_tpu.net import rtp as ref_rtp  # noqa: E402
from ultragrid_tpu.net import transmit as ref_transmit  # noqa: E402
from ultragrid_tpu.net.rtsp_client import parse_sdp as ref_parse_sdp  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import native  # noqa: E402
from ultragrid_tpu_torch.audio import aes67, capture, codecs, echo, filters, midi_synth  # noqa: E402
from ultragrid_tpu_torch.audio import playback, resampler, types, volume  # noqa: E402
from ultragrid_tpu_torch.modules import registry  # noqa: E402
from ultragrid_tpu_torch.net import audio_rx, pbuf, rtp, transmit  # noqa: E402
from ultragrid_tpu_torch.net import rtp_types as rt  # noqa: E402

PORT = {"types": types, "codecs": codecs, "capture": capture, "filters": filters, "playback": playback,
        "resampler": resampler, "volume": volume, "echo": echo, "audio_rx": audio_rx, "pbuf": pbuf,
        "rtp": rtp, "transmit": transmit}
REF = {"types": ref_types, "codecs": ref_codecs, "capture": ref_capture, "filters": ref_filters,
       "playback": ref_playback, "resampler": ref_resampler, "volume": ref_volume, "echo": ref_echo,
       "audio_rx": ref_audio_rx, "pbuf": ref_pbuf, "rtp": ref_rtp, "transmit": ref_transmit}
BOTH = {"port": PORT, "ref": REF}


@pytest.fixture(autouse=True)
def _clean_capture_format():
    yield
    capture._capture_format.clear()
    ref_capture._capture_format.clear()


def same_frame(a, b) -> bool:
    """Equal descriptions and channel bytes."""
    return (a.desc.bps, a.desc.sample_rate, a.desc.ch_count, a.desc.codec) == \
        (b.desc.bps, b.desc.sample_rate, b.desc.ch_count, b.desc.codec) and \
        len(a.channels) == len(b.channels) and \
        all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a.channels, b.channels))


def both_read(n: int, **kw):
    """The testcard's first ``n`` samples from each package."""
    return capture.TestcardAudioCapture(**kw).read(n), ref_capture.TestcardAudioCapture(**kw).read(n)


def seeded_frame(pkg, seed: int, n: int, ch: int = 2, bps: int = 2):
    mod = BOTH[pkg]["types"]
    rng = np.random.default_rng(seed)
    desc = mod.AudioDesc(bps=bps, sample_rate=48000, ch_count=ch)
    return mod.AudioFrame(desc, [rng.integers(0, 256, n * bps, dtype=np.uint8) for _ in range(ch)])


# ---------------------------------------------------------------------------
# types, codecs
# ---------------------------------------------------------------------------

def test_interleave_roundtrip():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, 2 * 2 * 100, dtype=np.int32).astype(np.uint8)
    f = types.AudioFrame.from_interleaved(types.AudioDesc(bps=2, sample_rate=48000, ch_count=2), data)
    r = ref_types.AudioFrame.from_interleaved(ref_types.AudioDesc(bps=2, sample_rate=48000, ch_count=2), data)
    assert f.sample_count == r.sample_count == 100
    assert same_frame(f, r)
    np.testing.assert_array_equal(f.to_interleaved(), data)
    np.testing.assert_array_equal(f.samples_float(), r.samples_float())
    assert types.AUDIO_TAGS == ref_types.AUDIO_TAGS and types.TAG_TO_CODEC == ref_types.TAG_TO_CODEC


def test_g711_exact_vs_reference_and_audioop():
    pcm = np.arange(-32768, 32768, dtype="<i2")
    codes = np.arange(256, dtype=np.uint8)
    for name in ("_linear_to_alaw", "_linear_to_mulaw"):
        np.testing.assert_array_equal(getattr(codecs, name)(pcm), getattr(ref_codecs, name)(pcm))
    for name in ("_alaw_to_linear", "_mulaw_to_linear"):
        np.testing.assert_array_equal(getattr(codecs, name)(codes), getattr(ref_codecs, name)(codes))
    audioop = pytest.importorskip("audioop")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert (np.frombuffer(audioop.lin2alaw(pcm.tobytes(), 2), np.uint8) == codecs._linear_to_alaw(pcm)).all()
        assert (np.frombuffer(audioop.ulaw2lin(codes.tobytes(), 2), "<i2") == codecs._mulaw_to_linear(codes)).all()


@pytest.mark.parametrize("name", ["PCM", "alaw", "ulaw"])
def test_codec_roundtrip_equals_reference(name):
    frame, ref_frame = both_read(4800)
    enc, ref_enc = codecs.get_audio_codec(name).compress(frame), ref_codecs.get_audio_codec(name).compress(ref_frame)
    assert same_frame(enc, ref_enc)
    dec = codecs.get_audio_codec(name).decompress(enc)
    assert same_frame(dec, ref_codecs.get_audio_codec(name).decompress(ref_enc))
    if name != "PCM":
        assert enc.desc.bps == 1
        assert np.abs(frame.samples_float() - dec.samples_float()).max() < 0.02  # G.711 on a 0.25 sine


@pytest.mark.parametrize("name", codecs.LAVC_AUDIO_CODECS)
def test_lavc_codecs_refused_by_name(name):
    """The libavcodec codecs under the reference's names: where libavcodec
    is present they are registered, and three audio cycles encode to the
    reference's packets and decode to its samples, byte for byte (one fresh
    instance in each package); where it is absent they are not registered,
    as in the reference, and building one names libavcodec."""
    cls = next(c for c in codecs.LAVC_CODECS if c.NAME == name)
    if not native.lavc_headers_present():
        assert name not in codecs._CODECS and name not in ref_codecs._CODECS
        with pytest.raises(ValueError, match="libavcodec"):
            cls()
        return
    assert codecs._CODECS[name] is cls
    port, ref = cls(), ref_codecs._CODECS[name]()
    for seq in range(3):
        frame, ref_frame = both_read(48000 // 25, frequency=440 + 100 * seq)
        got, want = port.compress_multi(frame), ref.compress_multi(ref_frame)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert same_frame(g, w)
            assert same_frame(port.decompress(g), ref.decompress(w))


@pytest.mark.parametrize("shim", ["loads", "absent"])
def test_lavc_registration_and_encoder_list_equal_the_reference(shim, monkeypatch):
    """``register_lavc_audio_codecs`` registers the same names as the
    reference's where the shim loads, and none where it does not (the
    loader forced to give nothing in both packages); ``lavc_encoders`` lists
    the reference's encoders, or none."""
    from ultragrid_tpu.audio import lavc_codecs as ref_lavc_codecs
    from ultragrid_tpu.modules import lavc as ref_lavc
    from ultragrid_tpu_torch.audio import lavc_codecs
    from ultragrid_tpu_torch.modules import lavc

    assert sorted(codecs._CODECS) == sorted(ref_codecs._CODECS)  # as imported
    if shim == "absent":
        monkeypatch.setattr(native, "lavc_shim_lib", lambda: None)
        monkeypatch.setattr(ref_lavc_codecs, "lavc_shim_lib", lambda: None)
        monkeypatch.setattr(ref_lavc, "lavc_shim_lib", lambda: None)
    lavc_names = {cls.NAME for cls in lavc_codecs.LAVC_CODECS}
    monkeypatch.setattr(codecs, "_CODECS", {k: v for k, v in codecs._CODECS.items() if k not in lavc_names})
    monkeypatch.setattr(ref_codecs, "_CODECS", {k: v for k, v in ref_codecs._CODECS.items() if k not in lavc_names})
    lavc_codecs.register_lavc_audio_codecs()
    ref_lavc_codecs.register_lavc_audio_codecs()
    assert sorted(codecs._CODECS) == sorted(ref_codecs._CODECS)
    loads = shim == "loads" and native.lavc_headers_present()
    assert lavc_names <= set(codecs._CODECS) if loads else not lavc_names & set(codecs._CODECS)
    assert lavc.lavc_encoders() == ref_lavc.lavc_encoders()
    assert bool(lavc.lavc_encoders()) == loads


# ---------------------------------------------------------------------------
# resampler, filters, mixer, volume, wav
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [44100, 32000, 96000])
def test_resampler_equals_reference(rate):
    frame, ref_frame = both_read(48000, frequency=1000)
    out = resampler.Resampler(rate).process(frame)
    assert same_frame(out, ref_resampler.Resampler(rate).process(ref_frame))
    assert out.desc.sample_rate == rate and abs(out.sample_count - rate) <= 1
    x = out.samples_float()[0]
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x))))
    assert abs(np.argmax(spec) * rate / len(x) - 1000) < 5  # the sine stays at 1 kHz


def test_gain_and_mute():
    frame, ref_frame = both_read(1000)
    g, rg = filters.GainFilter(gain_db=-6.02), ref_filters.GainFilter(gain_db=-6.02)
    out = g.apply(frame)
    assert same_frame(out, rg.apply(ref_frame))
    ratio = np.abs(out.samples_float()).max() / np.abs(frame.samples_float()).max()
    assert abs(ratio - 0.5) < 0.01
    g.muted = rg.muted = True
    muted = g.apply(frame)
    assert same_frame(muted, rg.apply(ref_frame)) and np.abs(muted.samples_float()).max() == 0


def test_channel_remap():
    frame, ref_frame = both_read(100)
    out = filters.ChannelRemap("0:1,1:0").apply(frame)
    assert same_frame(out, ref_filters.ChannelRemap("0:1,1:0").apply(ref_frame))
    np.testing.assert_allclose(out.samples_float()[0], frame.samples_float()[1], atol=1e-4)
    wide = filters.ChannelRemap("0:0,1:0,0:3")
    assert wide.out_channels == 4
    assert same_frame(wide.apply(frame), ref_filters.ChannelRemap("0:0,1:0,0:3").apply(ref_frame))


def test_delay_filter_over_two_frames():
    cap, ref_cap = capture.TestcardAudioCapture(), ref_capture.TestcardAudioCapture()
    d, rd = filters.DelayFilter(10), ref_filters.DelayFilter(10)
    first = d.apply(cap.read(100))
    assert same_frame(first, rd.apply(ref_cap.read(100)))
    assert (first.samples_float()[:, :10] == 0).all()
    assert same_frame(d.apply(cap.read(100)), rd.apply(ref_cap.read(100)))  # the tail carries over


def test_mixer():
    m, rm = filters.AudioMixer(types.AudioDesc()), ref_filters.AudioMixer(ref_types.AudioDesc())
    for ssrc, f in ((1, 1000), (2, 2000)):
        a, b = both_read(100, frequency=f)
        m.add(ssrc, a)
        rm.add(ssrc, b)
    out = m.mix()
    assert same_frame(out, rm.mix())
    c1, c2 = both_read(100, frequency=1000)[0], both_read(100, frequency=2000)[0]
    np.testing.assert_allclose(out.samples_float(), np.clip(c1.samples_float() + c2.samples_float(), -1, 1),
                               atol=1e-3)
    assert m.mix().sample_count == 0


def test_volume_stats_format_and_parse():
    sq = np.frombuffer((np.ones(480, "<i2") * 32767 * np.where(np.arange(480) % 2, 1, -1)).astype("<i2").tobytes(),
                       np.uint8)
    quiet = np.frombuffer((np.ones(480, "<i2") * 3277).astype("<i2").tobytes(), np.uint8)
    frame = types.AudioFrame(types.AudioDesc(bps=2, sample_rate=48000, ch_count=2), [sq, quiet])
    ref_frame = ref_types.AudioFrame(ref_types.AudioDesc(bps=2, sample_rate=48000, ch_count=2), [sq, quiet])
    for ch in range(2):
        assert volume.calculate_rms(frame, ch) == ref_volume.calculate_rms(ref_frame, ch)
    assert abs(volume.to_dbfs(volume.calculate_rms(frame, 0)[1])) < 0.01
    assert abs(volume.to_dbfs(volume.calculate_rms(frame, 1)[0]) - (-20.0)) < 0.1
    line = volume.format_stats_line("ARECV", frame)
    assert line == ref_volume.format_stats_line("ARECV", ref_frame)
    assert line.startswith("stats ARECV volrms0 ")
    assert volume.parse_stats_line(line) == ref_volume.parse_stats_line(line)
    assert volume.to_dbfs(0.0) == ref_volume.to_dbfs(0.0) == volume.MIN_DB
    for bps in (1, 4):
        f = seeded_frame("port", 3, 64, bps=bps)
        assert volume.calculate_rms(f, 0) == ref_volume.calculate_rms(seeded_frame("ref", 3, 64, bps=bps), 0)


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_wav_roundtrip_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "test.wav")
    frame = BOTH[writer]["capture"].TestcardAudioCapture().read(4800)
    pb = BOTH[writer]["playback"].WavAudioPlayback(path)
    pb.reconfigure(frame.desc)
    pb.put_frame(frame)
    pb.done()
    back = BOTH[reader]["capture"].WavAudioCapture(path).read(4800)
    np.testing.assert_array_equal(back.to_interleaved(), frame.to_interleaved())
    assert pb.samples_played == 4800


def test_audio_filter_factory_and_chain():
    spec = "gain:-6#delay:480#discard#controlport_stats#channel_remap:0:1#silence"
    chain, ref_chain = filters.make_audio_filter_chain(spec), ref_filters.make_audio_filter_chain(spec)
    assert [type(f).__name__ for f in chain] == [type(f).__name__ for f in ref_chain]
    assert chain[0].gain_db == ref_chain[0].gain_db == -6.0
    assert chain[1].samples == ref_chain[1].samples == 480
    assert chain[4].mapping == ref_chain[4].mapping
    with pytest.raises(ValueError):
        filters.make_audio_filter_chain("nosuchfilter")


def test_audio_filter_discard_silence_and_stats():
    frame, ref_frame = both_read(4800)
    assert filters.DiscardFilter().apply(frame) is None
    assert same_frame(filters.SilenceFilter().apply(frame), ref_filters.SilenceFilter().apply(ref_frame))

    class FakeControl:
        def __init__(self):
            self.lines = []

        def report_stats(self, line):
            self.lines.append(line)

    ctl, ref_ctl = FakeControl(), FakeControl()
    assert filters.ControlPortStats(ctl).apply(frame) is frame  # pass-through
    ref_filters.ControlPortStats(ref_ctl).apply(ref_frame)
    assert ctl.lines == ref_ctl.lines and 0 in volume.parse_stats_line(ctl.lines[-1])


# ---------------------------------------------------------------------------
# capture devices: testcard, -a, the MIDI synth, the registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", ["", "rate=44100:frequency=440:channels=1:volume=0.5"])
def test_testcard_capture_equals_reference(cfg):
    cap, ref_cap = capture.TestcardAudioCapture(cfg), ref_capture.TestcardAudioCapture(cfg)
    for n in (1920, 1920, 7):
        assert same_frame(cap.read(n), ref_cap.read(n))
    assert same_frame(capture.SilenceAudioCapture().read(10), ref_capture.SilenceAudioCapture().read(10))


@pytest.mark.parametrize("spec", ["channels=1", "bps=8:sample_rate=44.1k", "ch=8,bps=32,s=96000", "bps=24"])
def test_capture_format_equals_reference(spec):
    capture.set_audio_capture_format(spec)
    ref_capture.set_audio_capture_format(spec)
    assert capture.default_capture_desc() == types.AudioDesc(**vars(ref_capture.default_capture_desc()))
    if spec == "bps=24":
        # -a accepts 24 bits, but the testcard renders 8, 16 or 32 (the
        # reference's AudioFrame.from_float): both fail alike
        for cap in (capture.TestcardAudioCapture(), ref_capture.TestcardAudioCapture()):
            with pytest.raises(KeyError):
                cap.read(64)
        return
    assert same_frame(capture.TestcardAudioCapture().read(64), ref_capture.TestcardAudioCapture().read(64))


@pytest.mark.parametrize("bad", ["channels=0", "bps=12", "volume=3"])
def test_capture_format_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        ref_capture.set_audio_capture_format(bad)
    with pytest.raises(ValueError):
        capture.set_audio_capture_format(bad)


def test_midi_synth_equals_reference(tmp_path):
    song = midi_synth._bundled_song()
    assert song == ref_midi._bundled_song()
    events = midi_synth.parse_smf(song)
    assert events == ref_midi.parse_smf(song)
    np.testing.assert_array_equal(midi_synth.render_events(events, 8000), ref_midi.render_events(events, 8000))
    path = tmp_path / "song.mid"
    path.write_bytes(song)
    cap, ref_cap = (midi_synth.FluidSynthCapture(f"file={path}:loop=1"),
                    ref_midi.FluidSynthCapture(f"file={path}:loop=1"))
    for _ in range(3):
        assert same_frame(cap.read(4800), ref_cap.read(4800))
    with pytest.raises(ValueError, match="not a MIDI file"):
        midi_synth.parse_smf(b"RIFF0000")


def test_registry_holds_the_reference_names():
    """The port registers the reference's audio devices under their names;
    the reference's others are the stubs of ``modules/hw_stubs.py`` (devices
    whose SDKs neither package has), not in the port."""
    capture.initialize_audio_capture("none")
    ref_capture.initialize_audio_capture("none")
    for cls in ("AUDIO_CAPTURE", "AUDIO_PLAYBACK"):
        ours = set(registry.list_modules(getattr(registry.LibraryClass, cls)))
        ref_cls = getattr(ref_registry.LibraryClass, cls)
        theirs = set(ref_registry.list_modules(ref_cls))
        assert ours <= theirs, cls
        assert {ref_registry.load_library(n, ref_cls).__module__ for n in theirs - ours} <= \
            {"ultragrid_tpu.modules.hw_stubs"}, cls
    assert "import" in registry.list_modules(registry.LibraryClass.VIDEO_CAPTURE)
    assert isinstance(capture.initialize_audio_capture("testcard:frequency=500"), capture.TestcardAudioCapture)
    assert isinstance(playback.initialize_audio_playback("dummy"), playback.DummyAudioPlayback)
    with pytest.raises(ValueError, match="unknown audio capture"):
        capture.initialize_audio_capture("nosuchdevice")
    with pytest.raises(ValueError, match="unknown audio playback"):
        playback.initialize_audio_playback("nosuchdevice")


# ---------------------------------------------------------------------------
# echo canceller
# ---------------------------------------------------------------------------

def test_echo_cancellation_converges_and_equals_reference():
    """Synthetic echo through a short room impulse response: the port's
    canceller gives the reference's samples, and attenuates the echo by more
    than 15 dB (ERLE) after adaptation."""
    rng = np.random.default_rng(7)
    n_total = 48000  # 1 s
    far = rng.normal(0, 3000, n_total)
    h = np.zeros(400)
    h[10], h[150], h[320] = 0.8, -0.35, 0.15
    near = np.convolve(far, h)[:n_total]
    aec, ref_aec = echo.EchoCanceller(filter_length=2048, mu=0.5), ref_echo.EchoCanceller(filter_length=2048, mu=0.5)
    desc, ref_desc = types.AudioDesc(bps=2, ch_count=1), ref_types.AudioDesc(bps=2, ch_count=1)
    out = []
    for i in range(0, n_total, 512):
        seg_far = np.frombuffer(np.clip(far[i:i + 512], -32768, 32767).astype("<i2").tobytes(), np.uint8)
        seg_near = np.frombuffer(np.clip(near[i:i + 512], -32768, 32767).astype("<i2").tobytes(), np.uint8)
        aec.play(types.AudioFrame(desc, [seg_far]))
        ref_aec.play(ref_types.AudioFrame(ref_desc, [seg_far]))
        res = aec.cancel(types.AudioFrame(desc, [seg_near]))
        assert same_frame(res, ref_aec.cancel(ref_types.AudioFrame(ref_desc, [seg_near])))
        out.append(np.asarray(res.channels[0]).view("<i2").astype(np.float64))
    cleaned = np.concatenate(out)
    tail = slice(-12000, None)
    erle = 10 * np.log10((near[tail] ** 2).mean() / max((cleaned[tail] ** 2).mean(), 1e-9))
    assert erle > 15.0, f"ERLE {erle:.1f} dB"


# ---------------------------------------------------------------------------
# AES67
# ---------------------------------------------------------------------------

def _free_udp_port() -> int:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("codec,bps", [("L24", 3), ("L16", 2)])
def test_aes67_rtp_receive_equals_reference(codec, bps):
    """The same RTP L24/L16 packets into each package's capture: the same
    per-channel little-endian frames (ref: src/audio/capture/aes67.cpp)."""
    rng = np.random.default_rng(11)
    body = rng.integers(0, 256, 2 * 48 * 2 * bps, dtype=np.uint8).tobytes()
    frames = []
    for mod in (aes67, ref_aes67):
        port = _free_udp_port()
        cap = mod.Aes67Capture(f"addr=127.0.0.1:port={port}:codec={codec}:rate=48000:ch=2")
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            for i in range(2):
                half = body[i * len(body) // 2:(i + 1) * len(body) // 2]
                tx.sendto(struct.pack("!BBHII", 0x80, 96, i, i * 48, 0xABCD) + half, ("127.0.0.1", port))
            time.sleep(0.2)
            frames.append(cap.read(96))
        finally:
            tx.close()
            cap.done()
    assert frames[0] is not None and same_frame(*frames)
    assert frames[0].desc.bps == bps and frames[0].desc.ch_count == 2
    be = np.frombuffer(body, np.uint8).reshape(-1, 2, bps)
    np.testing.assert_array_equal(np.asarray(frames[0].channels[0]).reshape(-1, bps), be[:, 0, ::-1])


def test_sap_and_sdp_parsing_equal_reference():
    sdp = (b"v=0\r\no=- 1 1 IN IP4 10.0.0.5\r\ns=PTP stream\r\n"
           b"c=IN IP4 239.69.1.2/32\r\nt=0 0\r\n"
           b"m=audio 5004 RTP/AVP 98\r\na=rtpmap:98 L24/48000/8\r\na=fmtp:98 channel-order=SMPTE2110\r\n"
           b"m=audio 5006 RTP/AVP 0\r\n")
    pkt = bytes([0x20, 0, 0, 0]) + socket.inet_aton("10.0.0.5") + b"application/sdp\0" + sdp
    text = aes67.parse_sap(pkt)
    assert text == ref_aes67.parse_sap(pkt) and "L24/48000/8" in text
    assert [vars(m) for m in aes67.parse_sdp(text)] == [vars(m) for m in ref_parse_sdp(text)]
    for bad in (pkt[:6], bytes([0x00]) + pkt[1:], bytes([0x22]) + pkt[1:]):
        assert aes67.parse_sap(bad) == ref_aes67.parse_sap(bad) is None
    with pytest.raises(ValueError, match="unsupported codec"):
        aes67.Aes67Capture("codec=L8:port=0")


# ---------------------------------------------------------------------------
# RTP: the packets, and each package's Tx into the other's AudioRxState
# ---------------------------------------------------------------------------

class RecordingSession:
    """Stands in for an RtpSession: records each packet ``send_data_hdr``
    is given, in order."""

    def __init__(self):
        self.packets = []

    def send_data_hdr(self, ts, pt, m, payload_hdr, data, async_send=True):
        self.packets.append((pt, bool(m), bytes(payload_hdr) + bytes(data)))


def make_tx(pkg, mtu=1500):
    if pkg == "port":
        return transmit.Tx(mtu=mtu, device="cpu")
    return ref_transmit.Tx(mtu=mtu)


def node_of(pkg, packets, drop=()):
    """The recorded packets (less the indices in ``drop``) as a playout
    buffer node of ``pkg``."""
    mods = BOTH[pkg]
    node = mods["pbuf"].PbufNode(1234, time.monotonic(), 0.0)
    for i, (pt, m, payload) in enumerate(packets):
        if i not in drop:
            node.insert_packet(mods["rtp"].RtpPacket(pt, i, 1234, 0xABCD, m, payload, time.monotonic()))
    return node


def sent_packets(pkg, frame_pkg, seed, n, codec="PCM", fec="none", mtu=1500):
    frame = seeded_frame(frame_pkg, seed, n)
    if codec != "PCM":
        frame = BOTH[frame_pkg]["codecs"].get_audio_codec(codec).compress(frame)
    sess = RecordingSession()
    make_tx(pkg, mtu).send_audio(sess, frame, codec, fec_spec=fec)
    return sess.packets, frame


@pytest.mark.parametrize("codec,fec,mtu", [("PCM", "none", 1500), ("alaw", "none", 1500),
                                           ("ulaw", "none", 500), ("PCM", "rs:16:20", 500),
                                           ("PCM", "rs:16:24", 1500), ("PCM", "rs:200:240", 1500)])
def test_send_audio_packets_equal_reference(codec, fec, mtu):
    ours, _ = sent_packets("port", "port", 5, 1920, codec, fec, mtu)
    theirs, _ = sent_packets("ref", "ref", 5, 1920, codec, fec, mtu)
    assert ours == theirs
    assert [m for _, m, _ in ours].count(True) == 1 and ours[-1][1]
    assert {pt for pt, _, _ in ours} == {rt.PT_AUDIO_RS if fec != "none" else rt.PT_AUDIO}


@pytest.mark.parametrize("tx_pkg,rx_pkg", [("port", "ref"), ("ref", "port")])
@pytest.mark.parametrize("codec,fec,mtu,drop", [("alaw", "none", 1500, ()), ("PCM", "rs:16:20", 1500, ()),
                                                ("PCM", "rs:16:20", 500, (1,)), ("PCM", "rs:16:24", 1500, (1,))])
def test_audio_decode_across_packages(tx_pkg, rx_pkg, codec, fec, mtu, drop):
    """One package's packets decoded by the other's AudioRxState; with RS a
    lost data packet is recovered exactly."""
    packets, frame = sent_packets(tx_pkg, tx_pkg, 9, 2400, codec, fec, mtu)
    out = BOTH[rx_pkg]["audio_rx"].AudioRxState().decode_frame(node_of(rx_pkg, packets, drop))
    assert out is not None
    want = frame if codec == "PCM" else BOTH[tx_pkg]["codecs"].get_audio_codec(codec).decompress(frame)
    for ch in range(2):
        np.testing.assert_array_equal(np.asarray(out.channels[ch]), np.asarray(want.channels[ch]))
    assert out.desc.sample_rate == 48000 and out.desc.ch_count == 2


def rs_recovery(spec: str, nsamples: int, mtu: int = 1500):
    """(packets a channel, lost packets whose loss the port recovers) for one
    lost packet per frame at every packet position."""
    packets, frame = sent_packets("port", "port", 13, nsamples, "PCM", spec, mtu)
    state = audio_rx.AudioRxState()
    ok = 0
    for i in range(len(packets)):
        out = state.decode_frame(node_of("port", packets, (i,)))
        ref_out = ref_audio_rx.AudioRxState().decode_frame(node_of("ref", packets, (i,)))
        assert (out is None) == (ref_out is None), i
        if out is not None:
            assert np.array_equal(out.channels[0], frame.channels[0])
            assert np.array_equal(out.channels[1], frame.channels[1])
            ok += 1
    return len(packets), ok


def test_rs_16_24_recovers_any_one_lost_packet_at_the_session_shape():
    """48 kHz stereo 16-bit in chunks of 1920 samples (3,840 bytes a channel)
    at MTU 1500: ``A:rs:16:24`` recovers the loss of any one packet."""
    n, ok = rs_recovery("rs:16:24", 48000 // 25)
    assert n == ok == 10


def test_rs_200_240_loses_the_frame_with_a_full_packet():
    """The reference's own example ``A:rs:200:240``: 20-byte symbols, 72 of
    them to a full 1,440-byte packet against 40 parity symbols, so the loss
    of any full packet loses the frame, in the reference as in the port (a
    limit of the reference, not a port fault).  Only each channel's last,
    480-byte packet (24 symbols) is recoverable: 2 of 8."""
    n, ok = rs_recovery("rs:200:240", 48000 // 25)
    assert n == 8 and ok == 2


def test_encrypted_audio_from_the_reference_is_dropped_by_name(capsys):
    """The reference's encrypted audio (PT 25 and, with RS, PT 36): without a
    key the port drops the frame and says why; with the session's key the
    port decrypts it to the frame sent."""
    pytest.importorskip("cryptography")
    from ultragrid_tpu.utils.crypto import PacketCrypto

    from ultragrid_tpu_torch.utils.crypto import PacketCrypto as PortCrypto

    frame = seeded_frame("ref", 0, 480)
    for fec in ("none", "rs:4:6"):
        sess = RecordingSession()
        tx = ref_transmit.Tx(mtu=1500, encryption=PacketCrypto("sekrit"))
        tx.send_audio(sess, frame, "PCM", fec_spec=fec)
        assert {pt for pt, _, _ in sess.packets} <= {rt.PT_ENCRYPT_AUDIO, rt.PT_ENCRYPT_AUDIO_RS}
        assert audio_rx.AudioRxState().decode_frame(node_of("port", sess.packets)) is None
        out = audio_rx.AudioRxState(decryption=PortCrypto("sekrit")).decode_frame(node_of("port", sess.packets))
        assert out is not None and same_frame(out, frame)
    assert "no decryption key" in capsys.readouterr().err


@pytest.mark.parametrize("tx_pkg,rx_pkg", [("port", "ref"), ("ref", "port")])
def test_audio_rtp_end_to_end_across_packages(tx_pkg, rx_pkg):
    """Over 127.0.0.1: one package's RtpSession and Tx to the other's
    RtpSession, playout buffer and AudioRxState, RS with a lost packet."""
    port = _free_udp_port()
    tx_mods, rx_mods = BOTH[tx_pkg], BOTH[rx_pkg]
    rx = rx_mods["rtp"].RtpSession(addr=None, rx_port=port, tx_port=0)
    tx_sess = tx_mods["rtp"].RtpSession(addr="127.0.0.1", rx_port=0, tx_port=port)
    try:
        frame = seeded_frame(tx_pkg, 21, 2400)
        make_tx(tx_pkg, 500).send_audio(tx_sess, frame, "PCM", fec_spec="rs:16:20")
        buf = rx_mods["pbuf"].PlayoutBuffer()
        node = None
        deadline = time.monotonic() + 5
        while node is None and time.monotonic() < deadline:
            pkt = rx.recv(timeout=0.05)
            if pkt:
                buf.insert(pkt)
                if pkt.m:
                    node = list(buf.frames.values())[0]
        assert node is not None and len(node.packets) >= 4
        del node.packets[1]  # one lost data packet
        out = rx_mods["audio_rx"].AudioRxState().decode_frame(node)
        assert out is not None
        for ch in range(2):
            np.testing.assert_array_equal(np.asarray(out.channels[ch]), frame.channels[ch])
    finally:
        tx_sess.close()
        rx.close()


def test_port_tx_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        assert transmit.Tx().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            transmit.Tx()
    # standards-mode G.711 (PT 0 at 8 kHz): the same packets as the reference's
    port_rec, ref_rec = RecordingSession(), RecordingSession()
    n = transmit.Tx(device="cpu").send_audio_standard(port_rec, seeded_frame("port", 0, 160))
    assert n == ref_transmit.Tx().send_audio_standard(ref_rec, seeded_frame("ref", 0, 160)) == 1
    assert port_rec.packets == ref_rec.packets and port_rec.packets[0][0] == 0
