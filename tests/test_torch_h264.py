"""The port's device intra encoder (``ops/h264_device.py``) against the JAX
package's ``ops/h264_tpu.py`` on the CPU.

``Intra16EncoderDevice(device="cpu")`` gives access units byte-equal to
``Intra16EncoderTpu`` at qp 10, 26 and 40 at 64x48, with the overflow
escalation of the slot windows (the non-macroblock-aligned 72x40 is in
``test_torch_h264_nonaligned.py``, the P frames in ``test_torch_h264_p.py``);
the batched CAVLC, the pack and the exact Exp-Golomb bit length equal the
reference's.  Inputs are made from a seed with numpy; each reference graph
is built once per module (``tests/torch_h264_helpers.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ultragrid_tpu.ops import h264 as ref_h264  # noqa: E402
from ultragrid_tpu.ops import h264_tpu  # noqa: E402
from ultragrid_tpu.ops.h264_tpu import Intra16EncoderTpu  # noqa: E402

from ultragrid_tpu_torch.ops import h264_device as dev  # noqa: E402
from ultragrid_tpu_torch.ops.h264_device import Intra16EncoderDevice  # noqa: E402

from tests.torch_h264_helpers import picture, shared_reference_graphs  # noqa: E402,F401


# qp 10 needs about 65 words a macroblock on this content: both encoders
# start with windows of 160 words there, as the reference's escalation
# would reach
_INTRA = [(64, 48, qp, 160 if qp == 10 else 40) for qp in (10, 26, 40)]


@pytest.mark.parametrize("w,h,qp,wwords", _INTRA, ids=[f"{w}x{h}-qp{qp}" for w, h, qp, _ in _INTRA])
def test_intra_device_equals_reference(w, h, qp, wwords):
    frames = [picture(w, h, qp + i) for i in range(2)]
    ref = Intra16EncoderTpu(w, h, qp=qp, wwords=wwords)
    port = Intra16EncoderDevice(w, h, qp=qp, wwords=wwords, device="cpu")
    for i, f in enumerate(frames):
        a = ref.encode_uyvy(f)
        b = port.encode_uyvy(f)
        assert a == b, f"frame {i}: {len(a)} vs {len(b)} bytes"
        # the same frame as a tensor (the module's path) and as planes
        assert port.encode_uyvy(torch.as_tensor(f)) == a
    if w % 16 or h % 16:
        # the reference's UYVY entry takes its planes path here: no new graph
        y, cb, cr = ref_h264.uyvy_to_i420(frames[0], w, h)
        assert port.encode_planes(y, cb, cr) == ref.encode_planes(y, cb, cr)
    assert port.wwords == ref.wwords == wwords


def test_intra_device_overflow_escalation():
    """Windows of 10 words (blocks of 4) overflow at qp 26: both encoders
    widen them fourfold and give the same bytes."""
    w, h = 64, 48
    f = picture(w, h, 26)
    ref = Intra16EncoderTpu(w, h, qp=26, wwords=10)
    port = Intra16EncoderDevice(w, h, qp=26, wwords=10, device="cpu")
    assert port.encode_uyvy(f) == ref.encode_uyvy(f)
    assert port.wwords == ref.wwords == 40
    # the flag the escalation reads: set at 10 words, clear at 40
    y, cb, cr = dev.uyvy_to_planes(torch.as_tensor(f), w, h)
    assert bool(dev.make_device_encode(w, h, 26, 10, "cpu")(y, cb, cr)[2])
    assert not bool(dev.make_device_encode(w, h, 26, 40, "cpu")(y, cb, cr)[2])


@pytest.mark.parametrize("w,h", [(64, 48), (72, 40), (50, 38)])
def test_uyvy_split_on_the_device_equals_host_split(w, h):
    f = picture(w, h, 3)
    planes = dev.uyvy_to_planes(torch.as_tensor(f), w, h)
    want = ref_h264._pad_to_mb(*ref_h264.uyvy_to_i420(f, w, h))
    for got, exp in zip(planes, want):
        assert np.array_equal(got.numpy(), exp)


def _ref_tables():
    return h264_tpu._tables_jnp()


# (length L of the reference's block, chroma DC, nC choices)
_FAMILIES = [(16, False, (0, 1, 2, 3, 4, 7, 8, 12)), (15, False, (0, 2, 5, 9)), (4, True, (0,))]


@pytest.mark.parametrize("L,chroma_dc,ncs", _FAMILIES, ids=["luma16", "ac15", "chroma-dc"])
def test_cavlc_blocks_equal_reference(L, chroma_dc, ncs):
    """Batched CAVLC of seeded blocks (sparse, trailing ones, escapes, full
    blocks) against ``cavlc_blocks_jnp``: the 36 slot values and lengths."""
    rng = np.random.default_rng(L)
    n = 600
    lv = rng.integers(-3, 4, (n, L)) * (rng.random((n, L)) < rng.random((n, 1)))
    big = rng.random((n, L)) < 0.05
    lv = np.where(big, rng.integers(-3000, 3000, (n, L)), lv).astype(np.int32)
    lv[0] = 0
    lv[1] = 1
    nc = rng.choice(ncs, n).astype(np.int32)
    ref_v, ref_l, _ = h264_tpu.cavlc_blocks_jnp(jnp.asarray(lv), jnp.asarray(nc), _ref_tables(), chroma_dc=chroma_dc)
    padded = np.zeros((n, 16), np.int32)
    padded[:, :L] = lv
    tb = dev._tables(torch.device("cpu"))
    got_v, got_l = dev.cavlc_blocks(torch.as_tensor(padded), torch.as_tensor(nc),
                                    torch.full((n,), L, dtype=torch.int32), torch.full((n,), chroma_dc), tb)
    assert np.array_equal(got_l.numpy(), np.asarray(ref_l))
    assert np.array_equal(got_v.numpy(), np.asarray(ref_v))


def test_ue_bit_length_exact():
    """The float log2 with its two integer fix-ups gives the exact bit
    length at every power-of-two edge below 2^30, as the reference's (at
    2^30 - 1 float32 rounds up, and the log2 of PyTorch's CPU is one ulp
    above XLA's)."""
    edges = sorted({v for k in range(31) for v in (1 << k, (1 << k) - 1, (1 << k) + 1) if 1 <= v < 1 << 30})
    v = np.asarray(edges, np.int32)
    want = [int(x).bit_length() for x in edges]
    assert np.array_equal(dev._ue_bitlen(torch.as_tensor(v)).numpy(), want)
    assert np.array_equal(np.asarray(h264_tpu._ue_bitlen(jnp.asarray(v))), want)


def test_pack_equals_bitwriter():
    """The int64 scatter-add pack of disjoint symbols equals a BitWriter
    writing the same symbols, word for word."""
    rng = np.random.default_rng(5)
    nmb, nb = 3, 4
    ln = rng.integers(0, 29, (nmb * nb, dev._S)) * (rng.random((nmb * nb, dev._S)) < 0.4)
    val = rng.integers(0, 1 << 28, ln.shape) & ((1 << ln) - 1)
    words, bits, ovf = dev.pack_windows(torch.as_tensor(val.astype(np.int32)), torch.as_tensor(ln.astype(np.int32)),
                                        nmb, 256)
    assert not bool(ovf)
    wn = dev._words_to_host(words)
    for m in range(nmb):
        bw = ref_h264.BitWriter()
        for v_, l_ in zip(val[m * nb:(m + 1) * nb].reshape(-1), ln[m * nb:(m + 1) * nb].reshape(-1)):
            if l_:
                bw.u(int(v_), int(l_))
        total = len(bw.bytes) * 8 + bw.nbits
        assert int(bits[m]) == total
        row = dev._bit_window(*dev._writer_bits(bw), 256)[0]
        assert np.array_equal(wn[m], row)
