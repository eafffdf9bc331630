"""The port's device P-frame encoder (``InterEncoderDevice``) against the JAX
package's ``InterEncoderTpu`` on the CPU, at 64x48 and qp 24.

Every access unit is byte-equal and the reference pictures ``ref`` are equal
after every frame: motion search 0, 4 and 8, half- and quarter-pel refine, a
GOP that crosses an IDR, still content (all P_Skip), flat content on which
every candidate ties (the zero vector wins), and a scene change.  Where a
case starts mid-GOP, both encoders start from the same numpy reference
picture.  The port's own decoders read its stream back to its reference
pictures.  Each reference graph is built once per module
(``tests/torch_h264_helpers.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ultragrid_tpu.ops import h264 as ref_h264  # noqa: E402
from ultragrid_tpu.ops.h264_tpu import InterEncoderTpu  # noqa: E402

from ultragrid_tpu_torch.ops.h264_dec import StreamDecoder  # noqa: E402
from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice  # noqa: E402
from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder  # noqa: E402

from tests.torch_h264_helpers import moving, shared_reference_graphs  # noqa: E402,F401

W, H, QP = 64, 48, 24


def halfpel(n, speed, w=W, h=H):
    """Frames translated by ``speed`` luma samples a frame (sub-pel motion;
    the content of the reference's tests/test_h264.py:809-819)."""
    xx = np.arange(w, dtype=np.float32)
    out = []
    for i in range(n):
        g = 16 + (np.sin((xx - i * speed) * 0.35) * 0.5 + 0.5) * 200
        f = np.zeros((h, 2 * w), np.uint8)
        f[:, 1::2] = np.repeat(g[None, :], h, axis=0).astype(np.uint8)
        f[:, 0::2] = 128
        out.append(f)
    return out


def pair(start=None, w=W, h=H, qp=QP, **kw):
    """(reference encoder, port encoder); with ``start`` (a UYVY frame) both
    begin mid-GOP with its planes as the reference picture."""
    ref = InterEncoderTpu(w, h, qp=qp, **kw)
    port = InterEncoderDevice(w, h, qp=qp, device="cpu", **kw)
    if start is not None:
        planes = ref_h264._pad_to_mb(*ref_h264.uyvy_to_i420(start, w, h))
        ref.ref = tuple(jnp.asarray(p) for p in planes)
        port.ref = tuple(torch.as_tensor(p) for p in planes)
        for e in (ref, port):
            e._frame_idx = e._frame_num = 1
    return ref, port


def run(ref, port, frames):
    """Encode frames with both; every AU and every reference picture equal.
    Returns the AUs and the port's luma reference after each frame."""
    aus, lumas = [], []
    for i, f in enumerate(frames):
        a = ref.encode_uyvy(f)
        b = port.encode_uyvy(f)
        assert a == b, f"frame {i}: {len(a)} vs {len(b)} bytes"
        for k, (x, y) in enumerate(zip(ref.ref, port.ref)):
            assert np.array_equal(np.asarray(x), y.numpy()), f"frame {i} plane {k}"
        aus.append(b)
        lumas.append(port.ref[0].numpy().copy())
    assert port.wwords == ref.wwords
    return aus, lumas


def test_p_gop_crosses_an_idr_and_decodes_to_ref():
    """search 8, GOP 4: I P P P I P; both decoders of the port read the
    stream back to the encoder's reference pictures."""
    ref, port = pair(gop=4, search=8)
    aus, lumas = run(ref, port, moving(6, W, H))
    assert [au[4] & 0x1F for au in aus] == [7, 1, 1, 1, 7, 1]  # SPS first on an IDR
    fast = FastStreamDecoder()
    for i, au in enumerate(aus):
        y, _, _ = fast.decode_au(au)
        assert np.array_equal(y, lumas[i][:H, :W]), f"frame {i}"
    for i, (y, _, _) in enumerate(StreamDecoder().decode_stream(b"".join(aus))):
        assert np.array_equal(y, lumas[i][:H, :W]), f"python decoder, frame {i}"


def test_p_still_content_all_skip_then_scene_change():
    """Repeated frames converge to all P_Skip (a slice header and one skip
    run); then an unrelated picture, mid-GOP."""
    frames = moving(3, W, H, seed=1)
    still = [frames[-1]] * 3
    scene = moving(2, W, H, step=1, seed=7)
    ref, port = pair(start=frames[0], gop=30, search=8)
    aus, _ = run(ref, port, frames[1:] + still + scene)
    assert len(aus[4]) < 16, [len(a) for a in aus]
    assert len(aus[5]) > 2 * len(aus[3])


def test_p_flat_content_ties_to_the_zero_vector():
    """On flat content every candidate of every search stage has the same
    SAD: the first (zero) candidate wins, every macroblock is P_Skip."""
    flat = np.full((H, 2 * W), 128, np.uint8)
    flat[:, 1::2] = 90
    ref, port = pair(start=flat, gop=30, search=8)
    aus, lumas = run(ref, port, [flat, flat])
    for frame_num, au in enumerate(aus, start=1):
        bw = ref_h264.BitWriter()
        ref_h264._p_slice_header(bw, 0, frame_num)
        bw.ue((W // 16) * (H // 16))  # one skip run over the whole frame
        bw.rbsp_trailing()
        assert au == ref_h264.nal(3, 1, bw.rbsp())
    assert np.array_equal(lumas[-1][:H, :W], flat[:, 1::2])


def test_p_search0_equals_reference():
    frames = moving(4, W, H, step=2, seed=2)
    ref, port = pair(start=frames[0], gop=30, search=0)
    run(ref, port, frames[1:])


@pytest.mark.parametrize("subpel,speed", [("half", 0.5), ("quarter", 0.25)])
def test_p_subpel_search4_equals_reference(subpel, speed):
    """0.5 and 0.25 samples a frame: the refine picks sub-pel vectors and
    the P frames stay far below the first frame's size."""
    frames = halfpel(5, speed)
    ref, port = pair(start=frames[0], gop=30, search=4, subpel=subpel)
    aus, _ = run(ref, port, frames[1:])
    intra = len(ref_h264.Intra16EncoderV(W, H, qp=QP).encode_uyvy(frames[0]))
    assert all(len(a) < intra / 4 for a in aus), ([len(a) for a in aus], intra)
