"""iHDTV (``-x ihdtv``) of the port against the JAX package's, on the CPU.

The packets ``IhdtvConnection.send`` makes of a frame equal the reference's
(two streams, the 16-byte header, MTU 8192); each package's receiver
assembles the other's packets, in order, interleaved and with a newer
frame's packet arriving early (the flush), into the same frames; and a live
session over 127.0.0.1 both ways (the port's sender to the reference's
receiver and back, ports from the OS) shows the testcard converted to v210,
byte-equal in both.  A live session is retried up to three times: UDP on
localhost may drop a 5.5 MB frame's packets under load.
"""

import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules import extra_displays as ref_extra  # noqa: E402
from ultragrid_tpu.pipeline import ihdtv as ref_ihdtv  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.modules import extra_displays  # noqa: E402
from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture  # noqa: E402
from ultragrid_tpu_torch.ops import pixfmt  # noqa: E402
from ultragrid_tpu_torch.pipeline import ihdtv  # noqa: E402
from ultragrid_tpu_torch.types import Codec  # noqa: E402


def _frame(seed):
    return np.random.default_rng(seed).integers(0, 256, ihdtv.BYTES_PER_FRAME, dtype=np.uint8).tobytes()


class _TxSock:
    def __init__(self, out, sid):
        self.out, self.sid = out, sid

    def sendto(self, data, addr):
        self.out.append((self.sid, addr, bytes(data)))

    def close(self):
        pass


class _RxSock:
    """Hands out its datagrams one recv at a time, then would block."""

    def __init__(self, packets):
        self.packets = list(packets)

    def recv(self, n):
        if not self.packets:
            raise BlockingIOError
        return self.packets.pop(0)

    def close(self):
        pass


def _sent(mod, frames, mtu=8192):
    conn = mod.IhdtvConnection(mtu=mtu, ports=(3000, 3001))
    out = []
    conn.init_tx("127.0.0.1")
    conn.tx_socks = [_TxSock(out, 0), _TxSock(out, 1)]
    for f in frames:
        conn.send(f)
    return out


@pytest.mark.parametrize("mtu", [8192, 1400])
def test_packets_equal_reference(mtu):
    frames = [_frame(1), _frame(2)]
    port, ref = _sent(ihdtv, frames, mtu), _sent(ref_ihdtv, frames, mtu)
    assert port == ref
    assert ihdtv._packets_per_half(mtu) == ref_ihdtv._packets_per_half(mtu)
    n, last = ihdtv._packets_per_half(mtu)
    assert len(port) == 2 * 2 * n
    sid, addr, pkt = port[1]
    assert (sid, addr) == (1, ("127.0.0.1", 3001))
    assert ihdtv.HDR.unpack_from(pkt) == (1, 0, 0) and pkt[16:] == frames[0][ihdtv.HALF: ihdtv.HALF + min(mtu, 65520)]


def _receive(mod, streams, count, mtu=8192):
    conn = mod.IhdtvConnection(mtu=mtu, ports=(3000, 3001))
    conn.rx_socks = [_RxSock(streams[0]), _RxSock(streams[1])]
    return [bytes(conn.receive(timeout=0.5) or b"") for _ in range(count)]


@pytest.mark.parametrize("sender", ["port", "ref"])
def test_receivers_assemble_the_other_side_equal(sender):
    frames = [_frame(3), _frame(4), _frame(5)]
    sent = _sent(ihdtv if sender == "port" else ref_ihdtv, frames)
    streams = [[p for sid, _, p in sent if sid == s] for s in (0, 1)]
    port, ref = _receive(ihdtv, streams, 3), _receive(ref_ihdtv, streams, 3)
    assert port == ref == frames
    # frame 1 loses its last packet of stream 0: frame 2's first packet
    # flushes it early, zero-filled where the packet was lost, and frame 2
    # still comes whole
    per_half = ihdtv._packets_per_half(8192)[0]
    lossy = [streams[0][: 2 * per_half - 1] + streams[0][2 * per_half:], streams[1]]
    port, ref = _receive(ihdtv, lossy, 3), _receive(ref_ihdtv, lossy, 3)
    assert port == ref
    assert port[0] == frames[0] and port[2] == frames[2] and port[1] != frames[1]


def free_port_pair() -> int:
    for _ in range(64):
        a, b = socket.socket(socket.AF_INET, socket.SOCK_DGRAM), socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            a.bind(("", 0))
            p = a.getsockname()[1]
            b.bind(("", p + 1))
        except OSError:
            continue
        finally:
            a.close()
            b.close()
        return p
    raise RuntimeError("no free UDP port pair")


SPEC = "testcard:s=1920x1080:f=30:c=UYVY:still=1"


def _session(direction, n=2):
    got = []
    ports = (lambda p: (p, p + 1))(free_port_pair())
    key = f"ihdtv_{direction}"
    deliver = lambda f: got.append(np.asarray(f.data.numpy() if isinstance(f.data, torch.Tensor)  # noqa: E731
                                              else f.data).tobytes()) if f is not None else None
    if direction == "port->ref":
        ref_extra.register_pipe_delegate(key, deliver)
        rx = threading.Thread(target=ref_ihdtv.run_ihdtv_receiver, args=(f"pipe:{key}", n),
                              kwargs={"ports": ports}, daemon=True)
    else:
        extra_displays.register_pipe_delegate(key, deliver)
        rx = threading.Thread(target=ihdtv.run_ihdtv_receiver, args=(f"pipe:{key}", n),
                              kwargs={"ports": ports, "device": "cpu"}, daemon=True)
    rx.start()
    time.sleep(0.5)
    if direction == "port->ref":
        rc = ihdtv.run_ihdtv_sender(SPEC, "127.0.0.1", frame_limit=n + 2, ports=ports, device="cpu")
    else:
        rc = ref_ihdtv.run_ihdtv_sender(SPEC, "127.0.0.1", frame_limit=n + 2, ports=ports)
    rx.join(timeout=20)
    assert rc == 0 and not rx.is_alive()
    return got


def test_live_session_both_ways():
    want = pixfmt.convert_frame(initialize_video_capture(SPEC, device="cpu").frames[0], 1920, Codec.UYVY,
                                Codec.v210).numpy().tobytes()
    for direction in ("port->ref", "ref->port"):
        for _attempt in range(3):
            got = _session(direction)
            if got and got[0] == want:
                break
        assert got and got[0] == want, f"{direction}: {len(got)} frames, none whole"


def test_cli_ihdtv_accepted_and_refuses_other_sizes(capfd):
    assert cli.refusal(cli.build_parser().parse_args(["-x", "ihdtv", "-t", "testcard", "h"])) == ""
    rc = cli.main(["-x", "ihdtv", "-t", "testcard:s=64x32:f=30:c=UYVY", "--frames", "1", "--device", "cpu",
                   "127.0.0.1"])
    assert rc == 1 and "ihdtv requires 1920x1080 capture" in capfd.readouterr().err
