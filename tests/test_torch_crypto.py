"""The port's ``-e`` (``utils/crypto.py`` and its wiring) against the JAX
package's, on the CPU.

``PacketCrypto.encrypt`` draws 8 random IV bytes from ``os.urandom``; the
tests that compare packets fix that source to the same bytes in both
packages, so every packet is byte-equal, and then decrypt each package's
packets with the other.  GCM, CBC, CTR, CFB and ECB are covered; so are the
encrypted video and audio packets of ``Tx`` (recorded before the socket),
their reassembly by the other package, a live session over 127.0.0.1 in
both directions, and the port's CLI as a user runs it.  Tolerance: exact
equality.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("cryptography")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.net import transmit as ref_tx  # noqa: E402
from ultragrid_tpu.net.audio_rx import AudioRxState as RefAudioRx  # noqa: E402
from ultragrid_tpu.net.pbuf import PbufNode as RefNode  # noqa: E402
from ultragrid_tpu.net.rtp import RtpPacket as RefPacket  # noqa: E402
from ultragrid_tpu.net.video_rx import VideoRxState as RefRxState  # noqa: E402
from ultragrid_tpu.pipeline.receiver import VideoReceiver as RefReceiver  # noqa: E402
from ultragrid_tpu.pipeline.sender import VideoSender as RefSender  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402
from ultragrid_tpu.audio import types as ref_audio_types  # noqa: E402
from ultragrid_tpu.utils import crypto as ref_crypto  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.audio import types as audio_types  # noqa: E402
from ultragrid_tpu_torch.net import rtp_types as rt  # noqa: E402
from ultragrid_tpu_torch.net import transmit  # noqa: E402
from ultragrid_tpu_torch.net.audio_rx import AudioRxState  # noqa: E402
from ultragrid_tpu_torch.net.pbuf import PbufNode  # noqa: E402
from ultragrid_tpu_torch.net.rtp import RtpPacket  # noqa: E402
from ultragrid_tpu_torch.net.video_rx import VideoRxState  # noqa: E402
from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import crypto  # noqa: E402
from ultragrid_tpu_torch.utils import params  # noqa: E402

MODES = ["gcm", "cbc", "ctr", "cfb", "ecb"]


@pytest.fixture(autouse=True)
def _clean_params():
    yield
    params.reset_params()


def restart_ivs(monkeypatch):
    """Fix the IV source of both packages (``os.urandom``) to a counter
    from 1: the n-th call gives byte n repeated."""
    calls = iter(range(1, 1 << 20))
    monkeypatch.setattr(os, "urandom", lambda n: bytes([next(calls) & 0xFF]) * n)


def pair(mode: str, passphrase: str = "s3cret"):
    spec = f"{passphrase}:cipher={mode}"
    return crypto.PacketCrypto(spec), ref_crypto.PacketCrypto(spec)


@pytest.mark.parametrize("mode", MODES)
def test_packets_equal_both_ways(mode, monkeypatch):
    port, ref = pair(mode)
    assert port.key == ref.key and port.mode == ref.mode == crypto.MODE_NAMES[mode]
    assert port.crypto_header() == ref.crypto_header()
    rng = np.random.default_rng(MODES.index(mode))
    for n in (0, 1, 15, 16, 17, 1400):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        aad = rng.integers(0, 256, 24, dtype=np.uint8).tobytes()
        restart_ivs(monkeypatch)
        a = port.encrypt(data, aad)
        restart_ivs(monkeypatch)
        b = ref.encrypt(data, aad)
        assert a == b
        assert ref.decrypt(a, aad) == data and port.decrypt(b, aad) == data
    monkeypatch.undo()
    # random IVs: each package reads the other's packets
    data = rng.integers(0, 256, 999, dtype=np.uint8).tobytes()
    assert ref.decrypt(port.encrypt(data, b"h"), b"h") == data == port.decrypt(ref.encrypt(data, b"h"), b"h")


def test_tamper_and_wrong_aad_are_rejected():
    for port, ref in (pair("gcm"), pair("cbc")):
        enc = bytearray(ref.encrypt(b"hello world" * 10, b"hdr"))
        enc[25] ^= 0xFF
        assert port.decrypt(bytes(enc), b"hdr") is None is ref.decrypt(bytes(enc), b"hdr")
        good = ref.encrypt(b"hello", b"hdr")
        assert port.decrypt(good, b"other") is None is ref.decrypt(good, b"other")


def test_malformed_packets_return_none():
    """A truncated or crafted packet gives None, never an exception that
    would stop the receiver's loop, in both packages."""
    for mode in MODES:
        port, ref = pair(mode)
        ct = ref.encrypt(b"hello world payload", b"aad")
        for bad in (ct[:-3], b"\x00" * 21, b""):
            assert port.decrypt(bad, b"aad") == ref.decrypt(bad, b"aad")
        assert port.decrypt(b"", b"aad") is None


def test_passphrase_cipher_suffix():
    for name, mode in crypto.MODE_NAMES.items():
        assert crypto.PacketCrypto(f"k:cipher={name}").mode == mode
    assert crypto.PacketCrypto("k").mode == crypto.MODE_GCM
    assert crypto.PacketCrypto("k:cipher=nonsense").mode == ref_crypto.PacketCrypto("k:cipher=nonsense").mode


def test_missing_cryptography_is_named(monkeypatch):
    """Where the package is not installed, ``-e``
    raises an error that names it, in the port's sender and receiver."""
    monkeypatch.setitem(sys.modules, "cryptography.hazmat.primitives.ciphers", None)
    with pytest.raises(RuntimeError, match="cryptography"):
        crypto.PacketCrypto("k")
    with pytest.raises(RuntimeError, match="cryptography"):
        VideoSender("testcard:s=64x32:f=30:c=UYVY", "127.0.0.1", tx_port=0, encryption="k", device="cpu")
    with pytest.raises(RuntimeError, match="cryptography"):
        VideoReceiver("dummy", rx_port=0, encryption="k", device="cpu")


# ---------------------------------------------------------------------------
# Tx and the receive states
# ---------------------------------------------------------------------------


class Recorder:
    """Stands in for an RtpSession: each packet as (pt, m, payload), whether
    it was sent alone or in a batch."""

    def __init__(self):
        self.packets = []

    def send_data_hdr(self, ts, pt, m, payload_hdr, data, async_send=True):
        self.packets.append((pt, bool(m), bytes(payload_hdr) + bytes(data)))

    def send_batch(self, ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns=0):
        data = np.asarray(data, np.uint8).reshape(-1)
        for i, (off, n) in enumerate(zip(offsets, sizes)):
            self.send_data_hdr(ts, pt, m_last and i == len(sizes) - 1, bytes(hdrs[i]), data[off: off + n].tobytes())
        return len(sizes)


def node(pkg: str, packets):
    mk_node, mk_pkt = (PbufNode, RtpPacket) if pkg == "port" else (RefNode, RefPacket)
    n = mk_node(1234, time.monotonic(), 0.0)
    for i, (pt, m, payload) in enumerate(packets):
        n.insert_packet(mk_pkt(pt, i, 1234, 0xABCD, m, payload, time.monotonic()))
    return n


@pytest.mark.parametrize("mode", ["gcm", "cbc"])
@pytest.mark.parametrize("fec", ["none", "ldgm:16:8:3", "rs:16:20"])
def test_encrypted_video_packets_equal_and_decode_both_ways(fec, mode, monkeypatch):
    w, h = 96, 64
    data = np.random.default_rng(3).integers(0, 256, (h, 2 * w), dtype=np.uint8)
    pc, rc = pair(mode)
    port, ref = Recorder(), Recorder()
    for tx, rec, frame in (
            (transmit.Tx(mtu=1500, fec_spec=fec, encryption=pc, device="cpu"), port,
             VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [torch.as_tensor(data)], timestamp=10.0)),
            (ref_tx.Tx(mtu=1500, fec_spec=fec, encryption=rc), ref,
             RefFrame(RefDesc(w, h, RefCodec.UYVY, 30.0), [data], timestamp=10.0))):
        restart_ivs(monkeypatch)
        tx.send_video(rec, frame)
    assert port.packets == ref.packets and len(port.packets) >= 3
    want_pt = {"none": rt.PT_ENCRYPT_VIDEO, "ldgm:16:8:3": rt.PT_ENCRYPT_VIDEO_LDGM,
               "rs:16:20": rt.PT_ENCRYPT_VIDEO_RS}[fec]
    assert {pt for pt, _, _ in port.packets} == {want_pt}
    out = VideoRxState(device="cpu", decryption=pair(mode)[0]).decode_frame(node("port", ref.packets))
    assert out is not None and np.array_equal(out.data.cpu().numpy() if isinstance(out.data, torch.Tensor)
                                              else np.asarray(out.data), data)
    ref_out = RefRxState(decryption=pair(mode)[1]).decode_frame(node("ref", port.packets))
    assert ref_out is not None and np.array_equal(np.asarray(ref_out.data), data)
    # the wrong key, or none, drops the frame
    assert VideoRxState(device="cpu", decryption=pair(mode, "wrong")[0]).decode_frame(
        node("port", ref.packets)) is None
    assert VideoRxState(device="cpu").decode_frame(node("port", ref.packets)) is None


@pytest.mark.parametrize("fec", ["none", "rs:4:6"])
def test_encrypted_audio_equal_and_decodes_both_ways(fec, monkeypatch):
    rng = np.random.default_rng(5)
    chans = [rng.integers(0, 256, 1920, dtype=np.uint8) for _ in range(2)]
    frames = {"port": audio_types.AudioFrame(audio_types.AudioDesc(bps=2, sample_rate=48000, ch_count=2),
                                             [c.copy() for c in chans]),
              "ref": ref_audio_types.AudioFrame(ref_audio_types.AudioDesc(bps=2, sample_rate=48000, ch_count=2),
                                                [c.copy() for c in chans])}
    pc, rc = pair("gcm")
    recs = {}
    for side, tx in (("port", transmit.Tx(mtu=1500, encryption=pc, device="cpu")),
                     ("ref", ref_tx.Tx(mtu=1500, encryption=rc))):
        restart_ivs(monkeypatch)
        rec = Recorder()
        tx.send_audio(rec, frames[side], "PCM", fec_spec=fec)
        recs[side] = rec.packets
    assert recs["port"] == recs["ref"]
    assert {pt for pt, _, _ in recs["port"]} <= {rt.PT_ENCRYPT_AUDIO, rt.PT_ENCRYPT_AUDIO_RS}
    got = AudioRxState(decryption=pair("gcm")[0]).decode_frame(node("port", recs["ref"]))
    ref_got = RefAudioRx(decryption=pair("gcm")[1]).decode_frame(node("ref", recs["port"]))
    for out in (got, ref_got):
        assert out is not None
        assert all(np.array_equal(np.asarray(a), b) for a, b in zip(out.channels, chans))


# ---------------------------------------------------------------------------
# live sessions and the CLI
# ---------------------------------------------------------------------------


def free_port_pair() -> int:
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


def _session(direction: str, key: str, n_frames: int = 3):
    """One encrypted session over 127.0.0.1; the displayed frames."""
    port_no = free_port_pair()
    shown = []
    spec = "testcard:s=128x64:f=60:c=UYVY:still=1"
    if direction == "port->ref":
        recv = RefReceiver("dummy", rx_port=port_no, frame_limit=n_frames, timeout=10.0, encryption=key)
    else:
        recv = VideoReceiver("dummy", rx_port=port_no, frame_limit=n_frames, timeout=10.0, encryption=key,
                             device="cpu")
    orig = recv.display.put_frame

    def put(frame, blocking=True):
        if frame is not None:
            d = frame.data
            shown.append((d.cpu().numpy() if isinstance(d, torch.Tensor) else np.asarray(d)).copy())
        orig(frame, blocking)

    recv.display.put_frame = put
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    time.sleep(0.2)
    kw = dict(compress_spec="jpeg:80", fec_spec="ldgm:32:16:5", tx_port=port_no, mtu=1500,
              frame_limit=n_frames + 6, encryption=key)
    if direction == "port->ref":
        sender = VideoSender(spec, "127.0.0.1", device="cpu", **kw)
    else:
        sender = RefSender(spec, "127.0.0.1", **kw)
    sender.run()
    t.join(timeout=15)
    assert not t.is_alive(), "the receiver did not stop"
    return shown


def test_encrypted_live_session_both_ways():
    """``-e`` JPEG + LDGM sessions, port sender -> reference receiver and
    reference sender -> port receiver: every displayed frame equal."""
    frames = {}
    for direction in ("port->ref", "ref->port"):
        for _attempt in range(3):
            got = _session(direction, "sekrit:cipher=gcm")
            if len(got) >= 2:
                break
        assert len(got) >= 2, f"{direction}: {len(got)} frames displayed in 3 attempts"
        frames[direction] = got
    first = frames["port->ref"][0]
    assert all(np.array_equal(f, first) for got in frames.values() for f in got)


def test_encrypted_cli_session_on_the_cpu():
    """``python -m ultragrid_tpu_torch -e ...`` as a receiver and a sender on
    127.0.0.1 in one process (CBC, LDGM): the receiver displays its frames
    and both exit 0."""
    port = free_port_pair()
    rc = {}
    common = ["-e", "pass:cipher=cbc", "-P", str(port), "-n", "0", "--device", "cpu"]
    rx = threading.Thread(target=lambda: rc.setdefault("rx", cli.main(
        ["-d", "dummy", "--frames", "2", "--param", "pbuf-delay=5"] + common)), daemon=True)
    rx.start()
    for _ in range(3):
        rc["tx"] = cli.main(["-t", "testcard:s=64x32:f=60:c=UYVY:still=1", "-c", "jpeg", "-f", "ldgm:8:4:3",
                             "--frames", "10"] + common + ["127.0.0.1"])
        rx.join(timeout=10)
        if not rx.is_alive():
            break
    assert not rx.is_alive(), "the receiver did not display 2 frames"
    assert rc == {"rx": 0, "tx": 0}
