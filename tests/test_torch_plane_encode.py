"""K1's per-plane entry: the JPEG geometries without a mega matrix (4:4:4
from UYVY/YUYV, 4:2:2 from RGB/RGBA), on the CPU.

The plain per-plane path (``JpegEncoder.plane_coefficients``, then symbols
and pack), which the kernel ``jpeg_plane_encode_kernel`` is held to bit for
bit on the card, against the reference's per-plane stages with the chroma
resampling they lack (``tests/test_torch_session.py::_ref_per_plane_file``),
at restart intervals of every MCU, a non-divisor of the MCU row and one
segment a frame.  Every frame has at least 64 MCUs, so XLA's CPU dot sums
in the fused multiply-add chain's order.  Tolerance: byte-equal files.  And
the wrapper ``jpeg_cuda.plane_encode`` refuses what the kernel does not take
before it builds anything.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_session import _ref_per_plane_file  # noqa: E402
from ultragrid_tpu_torch import _build  # noqa: E402
from ultragrid_tpu_torch.ops import jpeg_cuda  # noqa: E402
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder  # noqa: E402
from ultragrid_tpu_torch.types import Codec  # noqa: E402

# (codec, subsampling, bytes per pixel, width, height): 128 MCUs of 8x8 at
# 4:4:4, 64 of 16x8 at 4:2:2
GEOMS = [(Codec.UYVY, "444", 2, 128, 64), (Codec.YUYV, "444", 2, 128, 64),
         (Codec.RGB, "422", 3, 128, 64), (Codec.RGBA, "422", 4, 128, 64)]


@pytest.mark.parametrize("codec,sub,bpp,w,h", GEOMS, ids=[f"{c.name}-{s}" for c, s, *_ in GEOMS])
@pytest.mark.parametrize("ri", [1, 7, "frame"])
def test_plain_per_plane_file_equals_reference_stages(codec, sub, bpp, w, h, ri):
    enc0 = JpegEncoder(w, h, in_codec=codec, quality=80, subsampling=sub)
    assert enc0.per_plane and enc0.nmcu >= 64
    ri = enc0.nmcu if ri == "frame" else ri
    frame = np.random.default_rng(w + 10 * bpp + ri).integers(0, 256, (h, w * bpp), dtype=np.uint8)
    ref = _ref_per_plane_file(w, h, codec, sub, frame, restart_interval=ri)
    enc = JpegEncoder(w, h, in_codec=codec, quality=80, restart_interval=ri, subsampling=sub)
    assert enc.restart_interval == ri
    before = jpeg_cuda.PLANE_LAUNCHES.count
    assert np.array_equal(enc.encode(torch.as_tensor(frame)), ref)
    assert jpeg_cuda.PLANE_LAUNCHES.count == before  # a CPU tensor takes the plain version


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if the wrapper reaches the kernels' build."""
    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper reached the kernels' build")

    monkeypatch.setattr(_build, "library_path", refuse)
    monkeypatch.setattr(_build, "kernels_lib", refuse)


def _args(codec=Codec.UYVY, sub="444", w=64, h=16):
    enc = JpegEncoder(w, h, in_codec=codec, subsampling=sub)
    t = enc.tables("cpu")
    frame = torch.zeros(h, enc.nmcux * enc.bpr, dtype=torch.uint8)
    kw = dict(layout=enc.layout, nmcux=enc.nmcux, nmcuy=enc.nmcuy, restart_interval=enc.restart_interval,
              wwords=enc.wwords)
    return [frame, t["w"], t["const"], t["huff"]], kw


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("frame_dtype", "frame"), ("frame_shape", "too small"), ("frame_dim", "frame"),
    ("w_dtype", "w:"), ("w_shape", "w:"), ("const_shape", "const"), ("huff_dtype", "huff"),
    ("layout", "layout"), ("wwords_0", "wwords"), ("wwords_65", "wwords"), ("ri_0", "restart"),
])
def test_plane_encode_refuses_before_any_build(no_build, case, match):
    args, kw = _args()
    frame, w, const, huff = args
    if case == "frame_dtype":
        args[0] = frame.to(torch.int32)
    elif case == "frame_shape":
        args[0] = frame[:, :-1].contiguous()
    elif case == "frame_dim":
        args[0] = frame[None]
    elif case == "w_dtype":
        args[1] = w.double()
    elif case == "w_shape":
        args[1] = w[:, :64].contiguous()
    elif case == "const_shape":
        args[2] = const[:64]
    elif case == "huff_dtype":
        args[3] = huff.long()
    elif case == "layout":
        kw["layout"] = 4
    elif case == "wwords_0":
        kw["wwords"] = 0
    elif case == "wwords_65":
        kw["wwords"] = 65
    elif case == "ri_0":
        kw["restart_interval"] = 0
    with pytest.raises(ValueError, match=match):
        jpeg_cuda.plane_encode(*args, **kw)


@pytest.mark.parametrize("codec,sub,layout", [(Codec.UYVY, "444", 0), (Codec.YUYV, "444", 1),
                                              (Codec.RGB, "422", 2), (Codec.RGBA, "422", 3)])
def test_per_plane_geometry_takes_its_layout(codec, sub, layout):
    """Each per-plane geometry names its own template of the kernel, whose
    MCU bytes match the encoder's."""
    enc = JpegEncoder(64, 16, in_codec=codec, subsampling=sub)
    k, nc, ny, mcu_h, bpr = jpeg_cuda.PLANE_GEOMETRY[enc.layout]
    assert enc.per_plane and enc.layout == layout
    assert (ny, mcu_h, bpr, nc) == (enc.ky, enc.mcu_h, enc.bpr, 64 * enc.blocks_per_mcu) and k == mcu_h * bpr
    assert tuple(enc.tables("cpu")["w"].shape) == (64, 128)
