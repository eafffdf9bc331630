"""The full-duplex session of the port on the CPU: ``-t ... -d ... <peer>``
sends and receives in one process (``pipeline/duplex.py``).

The cases of the reference's ``tests/test_duplex.py`` through the port's
CLI with ``--device cpu`` (a self-call with ``-c none``; JPEG with LDGM),
the same JPEG call in the reference for the same count of frames shown, and
``--echo-cancellation`` with mono testcard audio: one ``EchoCanceller``
shared by both halves, fed by the receiver's playback (far end) and
cleaning the sender's capture (near end).  Ports come from the OS.
"""

import re
import socket

import pytest

pytest.importorskip("torch")

import ultragrid_tpu.cli as ref_cli  # noqa: E402

from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.pipeline import duplex  # noqa: E402
from ultragrid_tpu_torch.utils import params  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_params():
    yield
    params.reset_params()


def free_ports(count=3) -> int:
    """A UDP port p with p + 1 .. p + count - 1 free too."""
    for _ in range(64):
        socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(count)]
        try:
            socks[0].bind(("", 0))
            p = socks[0].getsockname()[1]
            for i, s in enumerate(socks[1:], 1):
                s.bind(("", p + i))
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
        return p
    raise RuntimeError("no free UDP ports")


def _counts(err):
    sent = re.search(r"sent (\d+) frames", err)
    shown = re.search(r"displayed (\d+) frames", err)
    assert sent and shown, err
    return int(sent.group(1)), int(shown.group(1))


def test_duplex_self_call(capfd):
    rc = cli.main(["-t", "testcard:s=64x48", "-d", "dummy", "127.0.0.1", "-P", str(free_ports()),
                   "--control-port", "0", "--frames", "8", "-c", "none", "--device", "cpu"])
    assert rc == 0
    sent, shown = _counts(capfd.readouterr().err)
    assert sent == 8 and shown >= 4


@pytest.mark.parametrize("package", ["port", "ref"])
def test_duplex_jpeg_with_fec(package, capfd):
    argv = ["-t", "testcard:s=128x96", "-d", "dummy", "127.0.0.1", "-P", str(free_ports()),
            "--control-port", "0", "--frames", "6", "-c", "jpeg", "-f", "ldgm:32:6:3"]
    rc = cli.main(argv + ["--device", "cpu"]) if package == "port" else ref_cli.main(argv)
    assert rc == 0
    sent, shown = _counts(capfd.readouterr().err)
    assert sent == 6 and shown >= 3


def test_duplex_echo_cancellation_with_audio(capfd, monkeypatch):
    made = []

    class Counting(duplex.EchoCanceller):
        def __init__(self):
            super().__init__()
            self.played = self.cancelled = 0
            made.append(self)

        def play(self, frame):
            self.played += 1
            return super().play(frame)

        def cancel(self, frame):
            self.cancelled += 1
            return super().cancel(frame)

    monkeypatch.setattr(duplex, "EchoCanceller", Counting)
    rc = cli.main(["-t", "testcard:s=64x48:f=30", "-d", "dummy", "-s", "testcard:frequency=997:channels=1",
                   "-r", "dummy", "--echo-cancellation", "127.0.0.1", "-P", str(free_ports()),
                   "--control-port", "0", "--frames", "20", "--device", "cpu"])
    assert rc == 0
    err = capfd.readouterr().err
    assert "echo cancellation active" in err
    sent, shown = _counts(err)
    assert sent == 20 and shown >= 10
    (ec,) = made
    assert ec.cancelled >= 5 and ec.played >= 3


def test_duplex_echo_cancellation_needs_audio_both_ways(capfd, monkeypatch):
    """Without audio playback there is no far end: no canceller, as in the
    reference."""
    monkeypatch.setattr(duplex, "EchoCanceller", lambda: pytest.fail("no canceller without playback"))
    rc = cli.main(["-t", "testcard:s=64x48", "-d", "dummy", "-s", "testcard:channels=1", "--echo-cancellation",
                   "127.0.0.1", "-P", str(free_ports()), "--control-port", "0", "--frames", "4", "--device", "cpu"])
    assert rc == 0
    assert "echo cancellation active" not in capfd.readouterr().err
