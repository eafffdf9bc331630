"""The plain reference against the port's plain path on the CPU."""

import numpy as np
import pytest

from ugbench import content
from ugbench.reference import jpeg as rjpeg
from ugbench.reference import ldgm as rldgm


@pytest.fixture(scope="module")
def frame():
    return content.ring(2**32 + 3, 128, 32, n=1, device="cpu")[0]


@pytest.fixture(scope="module")
def encoded(frame):
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder

    enc = JpegEncoder(128, 32, quality=80)
    return enc, enc.encode(frame, device="cpu").tobytes()


def test_entropy_decode_gives_the_port_coefficients(frame, encoded):
    enc, data = encoded
    hdr, co, ok = rjpeg.decode_coefficients(data)
    assert ok.all() and hdr["ri"] == enc.restart_interval
    assert np.array_equal(co, enc.coefficients(frame).numpy().reshape(-1, 64))


def test_port_coefficients_are_the_float64_rounding(frame, encoded):
    _, data = encoded
    _, co, _ = rjpeg.decode_coefficients(data)
    ref, tol = rjpeg.forward_coefficients(frame.numpy(), 80)
    assert (np.abs(co - ref) <= 0.5 + tol).all()
    assert tol.max() < 1e-2


def test_port_decode_is_the_float64_inverse(encoded):
    from ultragrid_tpu_torch.ops.jpeg import JpegDecoder

    _, data = encoded
    hdr, co, _ = rjpeg.decode_coefficients(data)
    shown = JpegDecoder(device="cpu").decode_to_uyvy(data)[0].numpy()
    px, tol = rjpeg.uyvy_pixels(co, hdr)
    assert shown.shape == px.shape
    assert (np.abs(shown - px) <= 0.5 + tol).all()


def test_a_damaged_file_is_found(encoded):
    _, data = encoded
    hdr, co, ok = rjpeg.decode_coefficients(data)
    bad = bytearray(data)
    bad[len(bad) - 200] ^= 0x24
    _, co2, ok2 = rjpeg.decode_coefficients(bytes(bad))
    assert (~ok2).any() or not np.array_equal(co2, co)


def test_ldgm_matches_the_port():
    from ultragrid_tpu_torch.ops.fec import LdgmSession

    sess = LdgmSession(256, 26, 5)
    assert np.array_equal(rldgm.left_matrix(256, 26, 5, 1), sess.matrix)
    jpeg = np.random.default_rng(1).integers(0, 256, 20_000, dtype=np.uint8)
    hdr = np.zeros(24, np.uint8)
    hdr[8:12] = np.frombuffer(jpeg.size.to_bytes(4, "big"), np.uint8)
    buf, _ = sess.encode(np.concatenate([hdr, jpeg]))
    frame, data, par = rldgm.split_buffer(buf, 256, 26)
    assert np.array_equal(frame, jpeg)
    assert np.array_equal(rldgm.parity(data, 256, 26, 5, 1).reshape(-1), par)
