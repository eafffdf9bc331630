"""The port's device H.264 encoders at 72x40, a size that is not a whole
number of macroblocks, against the JAX package's on the CPU.

The planes are edge-padded to 80x48 (the reference's ``_pad_to_mb``) and the
SPS crops them back.  ``Intra16EncoderDevice`` at qp 10, 26 and 40 (the
reference's UYVY entry takes its planes path at this size), and
``InterEncoderDevice`` over an IDR, P frames with motion, and a second IDR:
byte-equal access units and equal reference pictures after every frame, once
both encoders hold the decoder's whole IDR picture (the reference's own is
edge-padded from the cropped output and drifts, ROADMAP F5).
Each reference graph is built once per module (``tests/torch_h264_helpers.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ultragrid_tpu.ops import h264 as ref_h264  # noqa: E402
from ultragrid_tpu.ops.h264_tpu import InterEncoderTpu, Intra16EncoderTpu  # noqa: E402

from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice, Intra16EncoderDevice  # noqa: E402
from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder  # noqa: E402

from tests.torch_h264_helpers import picture, shared_reference_graphs  # noqa: E402,F401

W, H = 72, 40


@pytest.mark.parametrize("qp,wwords", [(10, 160), (26, 40), (40, 40)], ids=["qp10", "qp26", "qp40"])
def test_intra_device_nonaligned_equals_reference(qp, wwords):
    ref = Intra16EncoderTpu(W, H, qp=qp, wwords=wwords)
    port = Intra16EncoderDevice(W, H, qp=qp, wwords=wwords, device="cpu")
    for i in range(2):
        f = picture(W, H, qp + i)
        a = ref.encode_uyvy(f)
        assert port.encode_uyvy(f) == a, f"frame {i}"
        y, cb, cr = ref_h264.uyvy_to_i420(f, W, H)
        assert port.encode_planes(y, cb, cr) == a
    assert port.wwords == ref.wwords == wwords


def frames_panned(n=5):
    """A smooth picture panned 2 samples right and 1 down a frame."""
    big = np.pad(picture(W, H, 3, noise=2.0), ((0, 8), (0, 32)), mode="reflect")
    return [np.ascontiguousarray(big[i:i + H, 4 * i:4 * i + 2 * W]) for i in range(n)]


def test_p_nonaligned_equals_reference_from_the_whole_idr_picture():
    """qp 26, search 8, GOP 3: I P P I P.  The IDRs are byte-equal; after
    each IDR the reference encoder is handed the port's reference picture
    (the decoder's whole picture, padding included), and from it the P
    frames are byte-equal with equal reference pictures.  The port's stream
    decodes to its reference picture at every frame."""
    ref = InterEncoderTpu(W, H, qp=26, gop=3, search=8)
    port = InterEncoderDevice(W, H, qp=26, gop=3, search=8, device="cpu")
    fast = FastStreamDecoder()
    for i, f in enumerate(frames_panned()):
        a = ref.encode_uyvy(f)
        assert port.encode_uyvy(f) == a, f"frame {i}"
        if i % 3 == 0:
            ref.ref = tuple(jnp.asarray(p.numpy()) for p in port.ref)
        for k, (x, y) in enumerate(zip(ref.ref, port.ref)):
            assert np.array_equal(np.asarray(x), y.numpy()), f"frame {i} plane {k}"
        y, cb, cr = fast.decode_au(a)
        assert y.shape == (H, W) and np.array_equal(y, port.ref[0].numpy()[:H, :W]), f"frame {i}"
        assert np.array_equal(cb, port.ref[1].numpy()[:H // 2, :W // 2])


def test_reference_inter_drifts_at_nonaligned_sizes():
    """ROADMAP F5, recorded: the reference takes the IDR's picture as the
    decoder's cropped output, edge-padded again; motion into the padding
    makes a decoder of its stream drift from its reference pictures.  The
    port's decodes exactly on the same frames."""
    ref = InterEncoderTpu(W, H, qp=26, gop=3, search=8)
    port = InterEncoderDevice(W, H, qp=26, gop=3, search=8, device="cpu")
    dec_ref, dec_port = FastStreamDecoder(), FastStreamDecoder()
    drift = []
    for f in frames_panned():
        y, _, _ = dec_ref.decode_au(ref.encode_uyvy(f))
        drift.append(int((y != np.asarray(ref.ref[0])[:H, :W]).sum()))
        y, _, _ = dec_port.decode_au(port.encode_uyvy(f))
        assert np.array_equal(y, port.ref[0].numpy()[:H, :W])
    assert drift[0] == drift[3] == 0 and drift[1] > 0, drift
