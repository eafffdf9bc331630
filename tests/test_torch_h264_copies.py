"""The H.264 host modules the port copies from the JAX package, against it
on the CPU.

``ops/h264.py``, ``h264_dec.py``, ``h264_8x8.py``, ``h264_deblock.py``,
``h264_bslice.py``, ``h264_cabac.py``, ``h264_cabac_tables.py``,
``h264_fast.py`` and ``h264_transcode.py`` are jax-free in the reference,
but the port imports nothing of it: each is a copy whose source equals the
reference's once the package name is renamed (and the absolute path of the
upstream checkout dropped from a docstring).  The copies' encoders (i16
vectorised and scalar, i4, I_PCM, the host P encoders), the CABAC
transcoder and both decoders give the reference's bytes and planes; the C
decoder, which rebuilds the device encoder's IDR reference picture, equals
the Python ``IntraDecoder`` the reference uses for it.
"""

import importlib
import pathlib
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from ultragrid_tpu.ops import h264 as ref_h264  # noqa: E402
from ultragrid_tpu.ops import h264_dec as ref_dec  # noqa: E402
from ultragrid_tpu.ops import h264_fast as ref_fast  # noqa: E402
from ultragrid_tpu.ops import h264_transcode as ref_tc  # noqa: E402

from ultragrid_tpu_torch import native  # noqa: E402
from ultragrid_tpu_torch.modules.video_compress import SessionTranscoder  # noqa: E402
from ultragrid_tpu_torch.ops import h264, h264_dec, h264_fast, h264_transcode  # noqa: E402

from tests.torch_h264_helpers import moving, picture  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
COPIES = ["h264", "h264_8x8", "h264_bslice", "h264_cabac", "h264_cabac_tables", "h264_deblock", "h264_dec",
          "h264_fast", "h264_transcode"]


def _renamed(text: str) -> str:
    text = text.replace("ultragrid_tpu.", "ultragrid_tpu_torch.")
    # "(/abs/path/to/reference/src/x.c" -> "(src/x.c"
    return re.sub(r"(?<=[(\s])/[\w./-]*?/(?=src/)", "", text)


@pytest.mark.parametrize("name", COPIES)
def test_copied_module_source_equals_reference(name):
    ref = (ROOT / "ultragrid_tpu" / "ops" / f"{name}.py").read_text()
    port = (ROOT / "ultragrid_tpu_torch" / "ops" / f"{name}.py").read_text()
    assert port == _renamed(ref)
    mod = importlib.import_module(f"ultragrid_tpu_torch.ops.{name}")
    assert mod.__file__.endswith(f"ultragrid_tpu_torch/ops/{name}.py")


# (class name, kwargs, frames): every host encoder a mode of H264Compress picks
_HOST = [("Intra16EncoderV", {"qp": 26}, 2), ("Intra16EncoderV", {"qp": 30, "deblock": True}, 1),
         ("Intra16Encoder", {"qp": 30}, 1), ("Intra4x4Encoder", {"qp": 28}, 2),
         ("Intra4x4Encoder", {"qp": 28, "deblock": True}, 1), ("PcmEncoder", {}, 1),
         ("InterEncoderV", {"qp": 26, "gop": 3, "search": 4}, 4), ("InterEncoder", {"qp": 26, "gop": 3, "search": 4}, 3)]


def _stream(mod, cls, kw, frames, w, h):
    enc = getattr(mod, cls)(w, h, **kw)
    return [bytes(enc.encode_uyvy(f)) for f in frames]


@pytest.mark.parametrize("w,h", [(64, 48), (72, 40)])
@pytest.mark.parametrize("cls,kw,n", _HOST, ids=[f"{c}-{i}" for i, (c, _, _) in enumerate(_HOST)])
def test_host_encoder_streams_equal_reference(cls, kw, n, w, h):
    frames = moving(n, w, h, seed=11)
    got = _stream(h264, cls, kw, frames, w, h)
    assert got == _stream(ref_h264, cls, kw, frames, w, h)
    # the decoders of both packages read the stream to the same planes
    for mod_fast, mod_dec in ((h264_fast, h264_dec), (ref_fast, ref_dec)):
        fast = mod_fast.FastStreamDecoder()
        planes = [fast.decode_au(au) for au in got]
        slow = mod_dec.StreamDecoder().decode_stream(b"".join(got))
        assert len(slow) == len(planes)
        for a, b in zip(planes, slow):
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
    ours = [h264_fast.FastStreamDecoder().decode_au(got[0])]
    theirs = [ref_fast.FastStreamDecoder().decode_au(got[0])]
    assert all(np.array_equal(x, y) for x, y in zip(ours[0], theirs[0]))


@pytest.mark.parametrize("src", ["i16", "inter"])
def test_cabac_transcode_equals_reference_and_decodes(src):
    """CAVLC -> CABAC: the copy's Transcoder and a module-owned handle
    (``SessionTranscoder``, one per H264Compress) give the reference's
    bytes, which both packages' decoders read to the CAVLC stream's planes."""
    w, h = 64, 48
    frames = moving(4, w, h, seed=11)
    cls, kw = ("Intra16EncoderV", {"qp": 26}) if src == "i16" else ("InterEncoderV", {"qp": 26, "gop": 3})
    cavlc = _stream(h264, cls, kw, frames, w, h)
    ref_t, port_t, own = ref_tc.Transcoder(), h264_transcode.Transcoder(), SessionTranscoder()
    try:
        for au in cavlc:
            want = ref_t.transcode_au(au)
            assert port_t.transcode_au(au) == want
            assert own.transcode_au(au) == want
    finally:
        own.close()
    tc = h264_transcode.Transcoder()
    cabac = [tc.transcode_au(au) for au in cavlc]
    d_cavlc, d_cabac, d_ref = (h264_fast.FastStreamDecoder(), h264_fast.FastStreamDecoder(),
                               ref_fast.FastStreamDecoder())
    for a, b in zip(cavlc, cabac):
        pa, pb, pr = d_cavlc.decode_au(a), d_cabac.decode_au(b), d_ref.decode_au(b)
        assert all(np.array_equal(x, y) and np.array_equal(x, z) for x, y, z in zip(pa, pb, pr))
    py = h264_dec.StreamDecoder().decode_stream(b"".join(cabac))
    assert len(py) == len(cabac)


@pytest.mark.parametrize("w,h,qp", [(64, 48, 26), (72, 40, 10), (72, 40, 40), (128, 72, 26)])
def test_c_decoder_equals_intra_decoder_on_idr(w, h, qp):
    """The device P encoder rebuilds each IDR's reference picture with the
    C decoder (the reference: the Python ``IntraDecoder``): the same planes,
    cropped and, under an SPS without cropping, whole."""
    f = picture(w, h, qp)
    slice_ = h264.Intra16EncoderV(w, h, qp=qp).encode_uyvy(f)[len(h264.make_sps(w, h) + h264.make_pps(qp)):]
    pw, ph = (w + 15) & ~15, (h + 15) & ~15
    for sps in (h264.make_sps(w, h, num_ref_frames=1), h264.make_sps(pw, ph, num_ref_frames=1)):
        au = sps + h264.make_pps(qp) + slice_
        fast = h264_fast.FastStreamDecoder().decode_au(au)
        for py in (h264_dec.IntraDecoder().decode(au), ref_dec.IntraDecoder().decode(au)):
            assert all(np.array_equal(x, y) for x, y in zip(fast, py))
    assert fast[0].shape == (ph, pw)


def test_native_loaders_build_the_shared_c():
    """The port's loaders build ``native/h264_assemble.c`` and
    ``native/h264_entropy.c`` into its own build directory, with the
    reference's argtypes."""
    from ultragrid_tpu import native as ref_native

    for name in ("h264_assemble_lib", "h264_fast_lib"):
        lib, ref_lib = getattr(native, name)(), getattr(ref_native, name)()
        assert "ultragrid_tpu_torch" in lib._name
        for fn in ("h264_assemble",) if name == "h264_assemble_lib" else (
                "h264fast_create", "h264fast_decode_au", "h264fast_dims", "h264fast_get_planes",
                "h264fast_flush_frame", "h264fast_error", "h264fast_destroy"):
            assert getattr(lib, fn).argtypes == getattr(ref_lib, fn).argtypes, fn
            assert getattr(lib, fn).restype == getattr(ref_lib, fn).restype, fn
