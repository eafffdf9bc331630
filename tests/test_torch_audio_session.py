"""Audio in the port's live session, and its record and replay, against the
JAX package's, on the CPU.

Sessions over 127.0.0.1 in both directions (the port's sender to the
reference's receiver and the other way round) with ``-s testcard -r wav``
and ``-f A:rs:16:24``, through the CLIs and through the sender and receiver
they build, one seeded audio packet dropped a frame in the second: every
audio frame played equals the one sent, byte for byte.  ``-E`` records the
same files as the reference's sender (and, unlike it, the audio: ROADMAP
F8), ``ImportCapture`` replays them as the reference's does, and ``-I``
sends them; ``--audio-delay``, ``--audio-scale``, runtime volume and mute
through the control socket, and ``astat`` against the port's control
socket.  The port runs on the CPU (``device="cpu"``); UDP ports come from
the OS; every thread is joined with a timeout.
"""

import io
import os
import socket
import threading
import time
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference on the CPU)

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu import cli as ref_cli  # noqa: E402
from ultragrid_tpu.audio import capture as ref_capture  # noqa: E402
from ultragrid_tpu.audio.types import AudioDesc as RefAudioDesc  # noqa: E402
from ultragrid_tpu.audio.types import AudioFrame as RefAudioFrame  # noqa: E402
from ultragrid_tpu.pipeline import receiver as ref_receiver_mod  # noqa: E402
from ultragrid_tpu.pipeline import sender as ref_sender_mod  # noqa: E402
from ultragrid_tpu.tools import astat as ref_astat  # noqa: E402
from ultragrid_tpu.utils import params as ref_params  # noqa: E402
from ultragrid_tpu.utils.export import ImportCapture as RefImportCapture  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.audio import capture  # noqa: E402
from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame  # noqa: E402
from ultragrid_tpu_torch.modules.messaging import Module  # noqa: E402
from ultragrid_tpu_torch.pipeline import receiver as receiver_mod  # noqa: E402
from ultragrid_tpu_torch.pipeline import sender as sender_mod  # noqa: E402
from ultragrid_tpu_torch.tools import astat  # noqa: E402
from ultragrid_tpu_torch.utils import params  # noqa: E402
from ultragrid_tpu_torch.utils.control_socket import ControlServer  # noqa: E402
from ultragrid_tpu_torch.utils.export import ImportCapture  # noqa: E402

from chip_smoke import drop_audio_packets, free_port_pair  # noqa: E402

AUDIO = "testcard:frequency=997"  # not periodic in a frame: every frame differs
VIDEO = "testcard:s=64x32:f=30:c=UYVY:still=1"


@pytest.fixture(autouse=True)
def _clean_state():
    yield
    params.reset_params()
    ref_params.reset_params()
    capture._capture_format.clear()
    ref_capture._capture_format.clear()


def expected_chunks(n: int = 80, chunk: int = 48000 // 25):
    """The sender's audio thread's first ``n`` frames of ``AUDIO``,
    interleaved."""
    cap = capture.TestcardAudioCapture(AUDIO.partition(":")[2])
    return [cap.read(chunk).to_interleaved().tobytes() for _ in range(n)]


def in_order(played, sent) -> bool:
    """Every played frame is a sent one, in the order sent (a frame the
    receiver's playout buffer dropped under load may be missing)."""
    j = 0
    for frame in played:
        while j < len(sent) and not frame_eq(sent[j], frame):
            j += 1
        if j == len(sent):
            return False
        j += 1
    return True


def frame_eq(a, b) -> bool:
    if isinstance(a, bytes):
        return a == b
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def read_wav(path) -> bytes:
    with wave.open(str(path), "rb") as wf:
        assert (wf.getnchannels(), wf.getsampwidth(), wf.getframerate()) == (2, 2, 48000)
        return wf.readframes(wf.getnframes())


def make_receiver(pkg, port, **kw):
    if pkg == "port":
        return receiver_mod.VideoReceiver("dummy", rx_port=port, device="cpu", **kw)
    return ref_receiver_mod.VideoReceiver("dummy", rx_port=port, **kw)


def make_sender(pkg, port, **kw):
    if pkg == "port":
        return sender_mod.VideoSender(VIDEO, "127.0.0.1", tx_port=port, device="cpu", **kw)
    return ref_sender_mod.VideoSender(VIDEO, "127.0.0.1", tx_port=port, **kw)


# ---------------------------------------------------------------------------
# sessions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tx,rx", [("port", "ref"), ("ref", "port")])
def test_cli_audio_session_across_packages(tmp_path, tx, rx):
    """``-s testcard -f A:rs:16:24`` into ``-r wav:<file>``, each side through
    its package's CLI: every 1/25 s chunk played is one the sender's testcard
    gave, in the order given."""
    mains = {"port": (cli.main, ["--device", "cpu"]), "ref": (ref_cli.main, [])}
    wav = tmp_path / "played.wav"
    port = free_port_pair(3)
    rx_main, rx_extra = mains[rx]
    tx_main, tx_extra = mains[tx]
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rx", rx_main(
        ["-d", "dummy", "-r", f"wav:{wav}", "-P", str(port), "--frames", "60", "-n", "0"] + rx_extra)),
        daemon=True)
    t.start()
    time.sleep(1.0)  # the receiver binds its sockets
    for _ in range(3):
        rc["tx"] = tx_main(["-t", VIDEO, "-s", AUDIO, "-f", "A:rs:16:24", "-P", str(port), "--frames", "90",
                            "-n", "0", "127.0.0.1"] + tx_extra)
        t.join(timeout=15)
        if not t.is_alive():
            break
    assert not t.is_alive(), "the receiver did not display 60 frames"
    assert rc == {"rx": 0, "tx": 0}
    played = read_wav(wav)
    chunk = len(expected_chunks(1)[0])
    want = expected_chunks()
    assert len(played) >= 3 * chunk and len(played) % chunk == 0
    assert in_order([played[i:i + chunk] for i in range(0, len(played), chunk)], want)


@pytest.mark.parametrize("tx,rx", [("port", "ref"), ("ref", "port")])
def test_rs_audio_session_with_loss_across_packages(tx, rx):
    """The sender and receiver the CLIs build, ``A:rs:16:24`` with one
    seeded audio packet dropped from every frame: each frame played is
    recovered, equal to the one sent, in order."""
    port = free_port_pair(3)
    recv = make_receiver(rx, port, timeout=30.0, audio_playback="dummy")
    played = []
    put = recv.audio_playback.put_frame
    recv.audio_playback.put_frame = lambda f: (played.append([np.array(c) for c in f.channels]), put(f))
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    snd = make_sender(tx, port, frame_limit=20, audio_capture=AUDIO, audio_fec="rs:16:24")
    sent = []
    send = snd.audio_tx.send_audio
    snd.audio_tx.send_audio = lambda s, f, *a, **k: (sent.append([np.array(c) for c in f.channels]),
                                                     send(s, f, *a, **k))[1]
    dropped = drop_audio_packets(snd.audio_session, 1, seed=3)
    snd.run()
    time.sleep(0.5)  # the last frames' playout delay
    recv.should_exit = True
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(played) >= 5 and len(dropped) >= len(played) and sum(dropped) == len(dropped)
    assert in_order(played, sent)


# ---------------------------------------------------------------------------
# -E and -I
# ---------------------------------------------------------------------------

def record(pkg, directory, frames=6):
    snd = make_sender(pkg, free_port_pair(3), frame_limit=frames, audio_capture=AUDIO, record=str(directory))
    assert snd.run() == frames


def test_record_and_replay_across_packages(tmp_path):
    """``-E``: the port writes the reference's files, and the audio it sent
    (``sound.wav``; the reference's sender writes none, F8).  Each package's
    ``ImportCapture`` replays the port's recording the same way."""
    ours, theirs = tmp_path / "port", tmp_path / "ref"
    record("port", ours)
    record("ref", theirs)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs) + ["sound.wav"])
    for name in os.listdir(theirs):
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    wav = read_wav(ours / "sound.wav")
    chunk = len(expected_chunks(1)[0])
    assert len(wav) >= chunk and wav == b"".join(expected_chunks(len(wav) // chunk))
    cap, ref_cap = ImportCapture(str(ours), device="cpu"), RefImportCapture(str(ours))
    replayed = b""
    for _ in range(6):
        (f, a), (rf, ra) = cap.grab(), ref_cap.grab()
        assert isinstance(f.data, torch.Tensor) and f.data.device.type == "cpu"
        assert np.array_equal(f.data.numpy(), np.asarray(rf.data))
        assert (a is None) == (ra is None)
        if a is not None:
            assert np.array_equal(a.to_interleaved(), ra.to_interleaved())
            replayed += a.to_interleaved().tobytes()
    assert cap.grab() == (None, None) == ref_cap.grab()
    assert replayed and replayed == wav[:len(replayed)]
    cap.done()
    ref_cap.done()


def test_import_capture_needs_a_device(tmp_path):
    record("port", tmp_path, frames=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            ImportCapture(str(tmp_path))


def test_cli_replay_sends_the_recording(tmp_path):
    """``-I DIR`` through the port's CLI: the capture is ``import:DIR`` with
    its embedded audio; the port's receiver plays the recorded wav."""
    rec = tmp_path / "rec"
    record("port", rec, frames=12)
    wav = read_wav(rec / "sound.wav")
    port = free_port_pair(3)
    recv = make_receiver("port", port, timeout=30.0, audio_playback=f"wav:{tmp_path / 'played.wav'}")
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    assert cli.main(["-I", str(rec), "-P", str(port), "-n", "0", "--device", "cpu", "127.0.0.1"]) == 0
    time.sleep(0.5)
    recv.should_exit = True
    t.join(timeout=10)
    assert not t.is_alive()
    played = read_wav(tmp_path / "played.wav")
    assert recv.frames_displayed >= 1
    assert len(played) >= 2 * 800 * 4 and played == wav[:len(played)]


@pytest.mark.parametrize("argv", [
    ["-I", "DIR", "h"],
    ["-I", "DIR", "-s", "none", "h"],
    ["-t", "testcard", "-s", "testcard", "-f", "A:rs:16:24", "-f", "V:ldgm:8:4:3", "h"],
    ["-t", "testcard", "-f", "a:rs:200:240", "-f", "rs:16:20", "-A", "ulaw", "h"],
    ["-t", "testcard", "-E", "-s", "wav:x.wav", "h"],
    ["-t", "testcard", "-s", "embedded", "-i", "gain:-6#silence", "-U", "0:1,1:0", "--audio-host", "10.0.0.2", "h"],
], ids=range(6))
def test_cli_maps_audio_options_as_the_reference(monkeypatch, tmp_path, argv):
    """What each CLI hands its sender after ``-f A:``/``V:``, ``-I`` and the
    rest are applied."""
    argv = [str(tmp_path) if a == "DIR" else a for a in argv]
    got = {}
    monkeypatch.setattr(sender_mod, "run_sender", lambda args: got.setdefault("port", vars(args)) and 0)
    monkeypatch.setattr(ref_sender_mod, "run_sender", lambda args: got.setdefault("ref", vars(args)) and 0)
    assert cli.main(argv) == 0
    assert ref_cli.main(argv) == 0
    for key in ("capture", "fec", "audio_fec", "audio_capture", "audio_codec", "record", "audio_filter",
                "audio_channel_map", "audio_host", "host"):
        assert got["port"][key] == got["ref"][key], key


def test_cli_audio_capture_format():
    for a in (["-a", "channels=1:sample_rate=32k"], ["--audio-capture-channels", "4"]):
        monkey = []
        sender_mod_run = sender_mod.run_sender
        sender_mod.run_sender = lambda args: monkey.append(capture.default_capture_desc()) or 0
        try:
            assert cli.main(["-t", "testcard", "h"] + a) == 0
        finally:
            sender_mod.run_sender = sender_mod_run
        ref_capture.set_audio_capture_format(a[1] if a[0] == "-a" else f"channels={a[1]}")
        assert monkey[0] == AudioDesc(**vars(ref_capture.default_capture_desc()))
        capture._capture_format.clear()
        ref_capture._capture_format.clear()
    assert cli.main(["-t", "testcard", "-a", "bps=12", "h"]) == 1


# ---------------------------------------------------------------------------
# --audio-delay, --audio-scale, volume and mute, astat
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ms,audio_s,video_s", [(200, 0.232, 0.032), (-100, 0.032, 0.132), (20, 0.052, 0.032)])
def test_audio_delay_maps_to_playout_offsets(monkeypatch, ms, audio_s, video_s):
    """--audio-delay: positive pads the audio playout delay, negative pads
    video (ref: set_audio_delay -> per-medium offsets, host.cpp:1019), on
    the receiver the CLI builds as on the reference's."""
    built = []
    monkeypatch.setattr(receiver_mod.VideoReceiver, "run", lambda self: built.append(self) or 0)
    assert cli.main(["-d", "dummy", "-r", "dummy", f"--audio-delay={ms}", "-P", str(free_port_pair(3)), "-n", "0",
                     "--device", "cpu"]) == 0
    ref = ref_receiver_mod.VideoReceiver("dummy", rx_port=free_port_pair(3), audio_playback="dummy",
                                         audio_delay_ms=ms)
    for r in (built[0], ref):
        assert abs(r.audio_pbuf.playout_delay - audio_s) < 1e-9
        assert abs(r.pbuf.playout_delay - video_s) < 1e-9
        r.session.close()
        r.audio_session.close()


def control(port: int, *commands) -> list:
    """Each command's reply line from the control socket on ``port``."""
    replies = []
    with socket.create_connection(("127.0.0.1", port), timeout=5) as s:
        f = s.makefile("rb")
        for c in commands:
            s.sendall(c.encode() + b"\r\n")
            replies.append(f.readline().decode().strip())
    return replies


@pytest.mark.parametrize("scale", ["none", "0.5", "auto"])
def test_audio_scale_volume_and_mute_through_the_control_socket(scale):
    """The port's receiver under ``--audio-scale`` takes ``volume``, ``mute``,
    ``unmute`` and ``av-delay`` from its control socket; its scaled frames
    equal the reference receiver's in the same state."""
    root = Module("root")
    ctl = ControlServer(root, 0)
    recv = receiver_mod.VideoReceiver("dummy", rx_port=free_port_pair(3), audio_playback="dummy", root=root,
                                      control=ctl, audio_scale=scale, device="cpu")
    ref = ref_receiver_mod.VideoReceiver("dummy", rx_port=free_port_pair(3), audio_playback="dummy",
                                         audio_scale=scale)
    rng = np.random.default_rng(4)
    chans = [rng.integers(0, 256, 960 * 2, dtype=np.uint8) for _ in range(2)]
    frame, ref_frame = AudioFrame(AudioDesc(), chans), RefAudioFrame(RefAudioDesc(), chans)
    try:
        for cmds, (vol, muted) in ((("volume 0.5",), (0.5, False)), (("volume up", "mute"), (0.5 * 10 ** 0.05, True)),
                                   (("unmute",), (0.5 * 10 ** 0.05, False)), (("volume down",), (0.5, False))):
            assert all(r.startswith("200") for r in control(ctl.port, *cmds))
            assert abs(recv.volume - vol) < 1e-12 and recv.muted == muted
            ref.volume, ref.muted = recv.volume, recv.muted
            for _ in range(2):  # auto follows the running peak
                out, want = recv._scale_audio(frame), ref._scale_audio(ref_frame)
                assert all(np.array_equal(a, b) for a, b in zip(out.channels, want.channels))
        assert control(ctl.port, "volume loud")[0].startswith("400")
        assert control(ctl.port, "av-delay -50")[0].startswith("200")
        assert abs(recv.pbuf.playout_delay - 0.082) < 1e-9 and abs(recv.audio_pbuf.playout_delay - 0.032) < 1e-9
    finally:
        ctl.close()
        for r in (recv, ref):
            r.session.close()
            r.audio_session.close()
    with pytest.raises(ValueError):
        receiver_mod.VideoReceiver("dummy", rx_port=0, audio_scale="50%", device="cpu")


@pytest.mark.parametrize("client", ["port", "ref"])
def test_astat_against_the_port_control_socket(client):
    """Both packages' ``astat`` read the ``stats ARECV`` lines of a port
    receiver's control socket: its volume stats of a played frame."""
    from ultragrid_tpu_torch.audio.volume import format_stats_line

    root = Module("root")
    cs = ControlServer(root, port=0)
    frame = capture.TestcardAudioCapture().read(1920)
    line = format_stats_line("ARECV", frame)
    try:
        def pump():
            for _ in range(20):
                cs.report_stats(line)
                time.sleep(0.05)

        t = threading.Thread(target=pump, daemon=True)
        t.start()
        out = io.StringIO()
        run = astat.run if client == "port" else ref_astat.run
        peaks = run("127.0.0.1", cs.port, seconds=1.5, out=out)
        t.join(timeout=5)
        assert set(peaks) == {0, 1}
        assert abs(peaks[0][1] - 20 * np.log10(0.25)) < 0.01  # the testcard's 0.25 sine
        assert "ch0:" in out.getvalue()
    finally:
        cs.close()


def test_receiver_reports_arecv_stats_to_astat():
    """A live port receiver with a control socket: astat sees the levels of
    the audio it plays."""
    root = Module("root")
    ctl = ControlServer(root, 0)
    port = free_port_pair(3)
    recv = receiver_mod.VideoReceiver("dummy", rx_port=port, timeout=30.0, audio_playback="dummy", root=root,
                                      control=ctl, device="cpu")
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    result = {}
    a = threading.Thread(target=lambda: result.setdefault("peaks", astat.run("127.0.0.1", ctl.port, seconds=2.0,
                                                                              out=io.StringIO())), daemon=True)
    a.start()
    time.sleep(0.3)
    make_sender("port", port, frame_limit=30, audio_capture="testcard").run()
    a.join(timeout=10)
    recv.should_exit = True
    t.join(timeout=10)
    ctl.close()
    assert not t.is_alive() and not a.is_alive()
    assert abs(result["peaks"][0][1] - 20 * np.log10(0.25)) < 0.01
