"""Faults planted on the route a frame on the card takes to the wire: its
file assembled where it was encoded (``JpegEncoder.encode_into``; a band's
body, ``ShardedJpegEncoder._encode_band``; the bands joined into one file,
``ShardedJpegEncoder.encode_file``) and its LDGM buffer built where the
file lives (``LdgmSession.encode_tensor``).

On the CPU a run takes the host's route, so each run here first sends the
CPU's tensors down the card's route: the encoders hand the file on as a
tensor and ``Tx`` builds its buffer with ``encode_tensor``.  A sound run
there is correct, and each plant is found by the check that reads what it
altered (the coefficients or the parity) in the buffers the sender sent."""

import time

import pytest
import torch

from ugbench import registry, run, session
from ugbench.tests import tiny

ONE_CARD = ("jpeg1080p-live-clean", "jpeg_ldgm_1080p")
BANDED = ("jpeg8k-tiled4-live-clean", "jpeg_ldgm_8k_tiled")


def one_run(cell_name, config):
    cfg = tiny.config(config)
    bench = registry.benchmark()
    cell = registry.cell(bench, cell_name)
    res = session.run_cell(cfg, tiny.traffic(cell["traffic"]), 2**32 + 91, 1.0, False, "cpu",
                           time.monotonic_ns())
    return run.result_line(run.summarize(bench, cell, cfg, res, 1.0, False, "cpu"), res, cfg)


@pytest.fixture
def card_route(monkeypatch):
    """The CPU's frames down the card's route; counts the LDGM buffers that
    ``Tx`` built there."""
    import ultragrid_tpu_torch.net.transmit as tx
    import ultragrid_tpu_torch.ops.jpeg as jp
    from ultragrid_tpu_torch.ops.fec import LdgmSession
    from ultragrid_tpu_torch.parallel import sharded_jpeg as sj

    built = {"buffers": 0}
    encode_tensor = LdgmSession.encode_tensor

    def counted(self, frame, hdr=b""):
        built["buffers"] += 1
        return encode_tensor(self, frame, hdr=hdr)

    monkeypatch.setattr(tx, "_on_card", lambda tile: isinstance(tile, torch.Tensor))
    monkeypatch.setattr(jp.JpegEncoder, "encode", lambda self, frame, device="cuda": self.encode_file(frame, device))
    monkeypatch.setattr(sj.ShardedJpegEncoder, "encode", lambda self, frame: self.encode_file(frame))
    monkeypatch.setattr(LdgmSession, "encode_tensor", counted)
    # the plants below replace these; each is put back after the test
    monkeypatch.setattr(jp.JpegEncoder, "encode_into", jp.JpegEncoder.encode_into)
    for name in ("_encode_band", "encode_file"):
        monkeypatch.setattr(sj.ShardedJpegEncoder, name, getattr(sj.ShardedJpegEncoder, name))
    return built


def altered_assembly():
    """One byte in the middle of each file's body, where the one-card
    encoder assembles it."""
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder

    orig = JpegEncoder.encode_into

    def encode_into(self, frame, prefix=0, **kw):
        buf = orig(self, frame, prefix=prefix, **kw)
        buf[prefix + (buf.numel() - prefix) // 2] ^= 0x5A
        return buf

    JpegEncoder.encode_into = encode_into


def altered_band():
    """One byte in the middle of the third band's body, where its card
    assembled it."""
    from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedJpegEncoder

    orig = ShardedJpegEncoder._encode_band

    def encode_band(self, s, band, frame_key):
        body = orig(self, s, band, frame_key)
        if s == 2:
            body[body.numel() // 2] ^= 0x5A
        return body

    ShardedJpegEncoder._encode_band = encode_band


def altered_join():
    """One byte in the middle of the file the bands' bodies were joined
    into, on the frame's card."""
    from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedJpegEncoder

    orig = ShardedJpegEncoder.encode_file

    def encode_file(self, frame):
        file = orig(self, frame)
        file[file.numel() // 2] ^= 0x5A
        return file

    ShardedJpegEncoder.encode_file = encode_file


def _altered_buffer(where):
    from ultragrid_tpu_torch.ops.fec import LdgmSession

    orig = LdgmSession.encode_tensor

    def encode_tensor(self, frame, hdr=b""):
        buf, desc = orig(self, frame, hdr=hdr)
        buf[where(buf, frame, hdr)] ^= 0x5A
        return buf, desc

    LdgmSession.encode_tensor = encode_tensor


def altered_buffer_file():
    """One byte of the file's copy in the LDGM buffer, after the parity."""
    _altered_buffer(lambda buf, frame, hdr: 4 + len(hdr) + frame.numel() // 2)


def altered_buffer_parity():
    """The last byte of the LDGM buffer's parity."""
    _altered_buffer(lambda buf, frame, hdr: buf.numel() - 1)


@pytest.mark.parametrize("cell,config", [ONE_CARD, BANDED], ids=["one_card", "banded"])
def test_a_sound_run_on_the_card_route_is_correct(cell, config, card_route):
    line = one_run(cell, config)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert card_route["buffers"] > 0


PLANTS = [(ONE_CARD, altered_assembly, "coef_off_ppm"), (BANDED, altered_band, "coef_off_ppm"),
          (BANDED, altered_join, "coef_off_ppm"), (ONE_CARD, altered_buffer_file, "coef_off_ppm"),
          (ONE_CARD, altered_buffer_parity, "parity_off")]


@pytest.mark.parametrize("where,plant,check", PLANTS, ids=[p.__name__ for _, p, _ in PLANTS])
def test_a_wrong_byte_on_the_card_route_is_not_correct(where, plant, check, card_route):
    plant()
    line = one_run(*where)
    checks = line["checks"]
    assert not line["correct"]
    # read from the buffers the sender sent: a sender that failed sends none
    assert checks[check]["value"] > checks[check]["limit"], checks
    assert card_route["buffers"] > 0
