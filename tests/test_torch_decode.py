"""The port's receive path (plain PyTorch versions on the CPU) against the JAX reference.

JPEG streams are made from numpy frames by the port's encoder, the
reference's encoder or PIL, and go through the reference's decoder (XLA on
the CPU) and ``ultragrid_tpu_torch``'s on the CPU.  The decode's float32
products run as one multiply-add per k in ascending k, the order of XLA's
CPU dot for 64 or more rows, so every case below has at least 64 MCUs (the
UYVY product) or blocks (the planes product).  Tolerance: byte equality
everywhere, and exact equality of the FEC buffers of the slice.

The reference decoder caches its per-stream products under table ids, not
table values, in its planes path (ops/jpeg.py:1486, and its module-level
decoder in ``decode_jpeg_to_frame``), so each reference decode here gets a
fresh decoder.
"""

import inspect
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402, F401  (both frameworks at the top; JAX stays on the CPU)

from ultragrid_tpu.modules import video_decompress as ref_vd  # noqa: E402
from ultragrid_tpu.ops import fec as ref_fec  # noqa: E402
from ultragrid_tpu.ops import jpeg as ref_jpeg  # noqa: E402
from ultragrid_tpu.types import Codec, VideoDesc, VideoFrame, vc_get_linesize  # noqa: E402
from ultragrid_tpu_torch import types as port_types  # noqa: E402
from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress  # noqa: E402
from ultragrid_tpu_torch.ops import fec as port_fec  # noqa: E402
from ultragrid_tpu_torch.ops import jpeg as port_jpeg  # noqa: E402


@pytest.fixture(autouse=True)
def fresh_reference_decoder(monkeypatch):
    monkeypatch.setattr(ref_jpeg, "_DEVICE_DECODER", None)


def uyvy_content(w, h, seed, kind="content"):
    ls = vc_get_linesize(w, Codec.UYVY)
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, ls), dtype=np.uint8)
    # gradient plus sensor-like noise, limited range (as bench.py)
    base = np.linspace(0, 255, ls, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


def port_stream(w, h, q=80, sub=None, seed=1, kind="content"):
    enc = port_jpeg.JpegEncoder(w, h, quality=q, subsampling=sub)
    return bytes(enc.encode(uyvy_content(w, h, seed, kind), device="cpu"))


def ref_stream(w, h, q=80, sub=None, seed=1, kind="content"):
    return bytes(ref_jpeg.JpegEncoder(w, h, quality=q, subsampling=sub).encode(uyvy_content(w, h, seed, kind)))


def pil_stream(w, h, subsampling):
    """An RGB gradient with texture through PIL (libjpeg), subsampling 0 =
    4:4:4, 2 = 4:2:0 (as tests/test_compress.py:117)."""
    Image = pytest.importorskip("PIL.Image")
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // w, y * 255 // h, (x ^ y) & 255], axis=-1).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "JPEG", quality=90, subsampling=subsampling)
    return buf.getvalue()


def jpeg_frame(data, w, h, port=False):
    if port:
        return port_types.VideoFrame(port_types.VideoDesc(w, h, port_types.Codec.JPEG, 30.0),
                                     [np.frombuffer(data, np.uint8)])
    return VideoFrame(VideoDesc(w, h, Codec.JPEG, 30.0), [np.frombuffer(data, np.uint8)])


STREAMS = {
    "port 422 q80": lambda: port_stream(256, 64),
    "ref 422 q95 noise": lambda: ref_stream(256, 64, 95, kind="noise"),
    "port 420 q80": lambda: port_stream(256, 128, sub="420"),
    "pil 420": lambda: pil_stream(256, 128, 2),
    "pil 444": lambda: pil_stream(128, 64, 0),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_parse_headers_matches_reference(name):
    data = STREAMS[name]()
    want, got = ref_jpeg._parse_headers(data), port_jpeg._parse_headers(data)
    assert set(got) == set(want)
    assert set(got["qtabs"]) == set(want["qtabs"])
    for tid in want["qtabs"]:
        assert np.array_equal(got["qtabs"][tid], want["qtabs"][tid])
    for key in ("htabs", "ri", "scan", "h", "w", "scan_start"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("w,h,q,kind", [(256, 64, 80, "content"), (256, 64, 95, "noise"),
                                        (512, 128, 100, "noise")])
def test_entropy_decodes_match_reference(w, h, q, kind):
    """Both host halves; the q100 noise frame has more than ``_EXC_CAP``
    exceptions, so its packed decode is None on both."""
    data = port_stream(w, h, q, kind=kind)
    want, got = ref_jpeg.entropy_decode_422_packed(data), port_jpeg.entropy_decode_422_packed(data)
    assert (got is None) == (want is None) == (q == 100)
    if want is not None:
        _, lo, dc, idx, dv, count, nmcux, nmcuy = want
        assert (got[5], got[6], got[7]) == (count, nmcux, nmcuy)
        for a, b in ((lo, got[1]), (dc, got[2]), (idx[:count], got[3][:count]), (dv[:count], got[4][:count])):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    want, got = ref_jpeg.entropy_decode_422(data), port_jpeg.entropy_decode_422(data)
    assert got[2:] == want[2:]
    for a, b in zip(want[1], got[1]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port_jpeg.entropy_decode_422(STREAMS["port 420 q80"]()) is None


@pytest.mark.parametrize("w,h,q,kind", [
    (256, 64, 60, "content"), (256, 64, 80, "content"), (256, 64, 95, "noise"),
    (1920, 1080, 80, "content"),
    (512, 128, 100, "noise"),  # a fat frame: the int16 upload
])
def test_decode_to_uyvy_matches_reference(w, h, q, kind):
    data = port_stream(w, h, q, kind=kind)
    want, wh, ww = ref_jpeg.JpegDecoder().decode_to_uyvy(data)
    got, gh, gw = port_jpeg.JpegDecoder("cpu").decode_to_uyvy(data)
    assert (gh, gw) == (wh, ww) == (h, w)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("sub", ["422", "420"])
def test_decoder_cache_keyed_on_quant_values(sub):
    """One decoder, q60 -> q90 -> q60 at one geometry
    (tests/test_compress.py:363), through the UYVY product (4:2:2) and the
    planes path (4:2:0): each decode equals a fresh reference decoder's,
    and stays close to the source."""
    from ultragrid_tpu.utils.pattern import generate_pattern

    w, h = 192, 128
    uy = generate_pattern(w, h, Codec.UYVY, "bars")
    dec = port_jpeg.JpegDecoder("cpu")
    for q in (60, 90, 60):
        data = bytes(port_jpeg.JpegEncoder(w, h, quality=q, subsampling=sub).encode(uy, device="cpu"))
        got = port_jpeg.decode_jpeg_to_frame(jpeg_frame(data, w, h, port=True), port_types.Codec.UYVY,
                                             decoder=dec).data.numpy()
        ref_jpeg._DEVICE_DECODER = None
        assert np.array_equal(got, np.asarray(ref_jpeg.decode_jpeg_to_frame(jpeg_frame(data, w, h),
                                                                            Codec.UYVY).data))
        assert np.abs(got.astype(int) - uy.astype(int)).mean() < (4.0 if sub == "422" else 6.0), q


def test_reverse_mega_matrix_bit_equal():
    """The reference builds its matrix inside ``_make_mega_uyvy_fn`` and
    keeps it in the jitted function's closure."""
    data = port_stream(256, 64, 60)
    hdr = ref_jpeg._parse_headers(data)
    fn = ref_jpeg.JpegDecoder()._make_mega_uyvy_fn(hdr, 16, 8)
    want = np.asarray(inspect.getclosurevars(inspect.unwrap(fn)).nonlocals["Wj"])
    scan = hdr["scan"]
    got = port_jpeg.reverse_mega_matrix(hdr["qtabs"][scan[0]["tq"]], hdr["qtabs"][scan[1]["tq"]])
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", list(STREAMS))
def test_planes_path_matches_reference(name):
    data = STREAMS[name]()
    want = ref_jpeg.JpegDecoder().decode(data)
    got = port_jpeg.decode_jpeg_device(data, device="cpu")
    assert got[1:] == want[1:]
    for a, b in zip(want[0], got[0]):
        assert b.dtype == torch.uint8 and np.array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("name", ["port 420 q80", "pil 420", "pil 444", "port 422 q80"])
@pytest.mark.parametrize("out_codec", [Codec.UYVY, Codec.RGB])
def test_decode_jpeg_to_frame_matches_reference(name, out_codec):
    data = STREAMS[name]()
    h, w = ref_jpeg._parse_headers(data)["h"], ref_jpeg._parse_headers(data)["w"]
    want = ref_jpeg.decode_jpeg_to_frame(jpeg_frame(data, w, h), out_codec)
    got = JpegDecompress(device="cpu").decompress(jpeg_frame(data, w, h, port=True),
                                                  port_types.Codec(out_codec))
    assert got.desc.color_spec == port_types.Codec(out_codec) and got.desc.width == w
    assert got.data.dtype == torch.uint8 and np.array_equal(got.data.numpy(), np.asarray(want.data))


@pytest.mark.parametrize("keep", [0.3, 0.95, -2])
@pytest.mark.parametrize("out_codec", [Codec.UYVY, Codec.RGB])
def test_truncated_stream_gives_reference_result(keep, out_codec):
    """A stream the C scan decoder rejects goes to the pure-Python decoder,
    as in the reference: the same exception where the data runs out, the
    same frame where only the EOI marker is missing (``keep`` = -2)."""
    data = port_stream(256, 64)
    data = data[:keep] if keep < 0 else data[: int(len(data) * keep)]

    def outcome(fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            return type(e)

    want = outcome(lambda: np.asarray(ref_jpeg.decode_jpeg_to_frame(jpeg_frame(data, 256, 64), out_codec).data))
    got = outcome(lambda: JpegDecompress(device="cpu").decompress(
        jpeg_frame(data, 256, 64, port=True), port_types.Codec(out_codec)).data.numpy())
    if isinstance(want, type):
        assert got is want and want is not ValueError
    else:
        assert np.array_equal(got, want)


def test_pure_python_decoder_matches_reference():
    data = port_stream(128, 64, 95, kind="noise")
    want = ref_jpeg.decode_jpeg(data, collect_coeffs=True)
    got = port_jpeg.decode_jpeg(data, collect_coeffs=True)
    assert got[1:4] == want[1:4]
    for a, b in zip(want[0] + want[4], got[0] + got[4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("nloss,seed", [(3, 1), (6, 2), (20, 3)])
def test_receive_slice_matches_reference(nloss, seed):
    """The slice as a whole: JPEG encode -> LDGM encode -> loss -> device
    peel -> JpegDecompress -> UYVY, through the port on the CPU and through
    the reference, on the same bytes.  20 lost of 80 symbols is beyond the
    peel: None on both."""
    w, h = 256, 64
    src = uyvy_content(w, h, 5)
    k, m, c = 64, 16, 5
    file_p = port_jpeg.JpegEncoder(w, h).encode(src, device="cpu")
    file_r = np.asarray(ref_jpeg.JpegEncoder(w, h).encode(src))
    assert np.array_equal(file_p, file_r)
    buf_p, desc_p = port_fec.LdgmSession(k, m, c).encode(file_p)
    buf_r, desc_r = ref_fec.LdgmSession(k, m, c).encode(file_r)
    assert np.array_equal(buf_p, buf_r) and desc_p.symbol_size == desc_r.symbol_size
    sym = buf_r.reshape(k + m, desc_r.symbol_size).copy()
    present = np.ones(k + m, bool)
    present[np.random.default_rng(seed).choice(k + m, nloss, replace=False)] = False
    sym[~present] = 0
    rec_r = ref_fec.LdgmSession(k, m, c).decode_device(sym.copy(), present.copy())
    rec_p = port_fec.LdgmSession(k, m, c).decode_device(torch.as_tensor(sym), present)
    assert (rec_p is None) == (rec_r is None) == (nloss == 20)
    if rec_r is None:
        return
    assert np.array_equal(rec_p, np.asarray(rec_r)) and np.array_equal(rec_p, file_p)
    want = ref_vd.JpegDecompress().decompress(jpeg_frame(bytes(np.asarray(rec_r)), w, h), Codec.UYVY)
    got = JpegDecompress(device="cpu").decompress(jpeg_frame(bytes(rec_p), w, h, port=True),
                                                  port_types.Codec.UYVY)
    assert np.array_equal(got.data.numpy(), np.asarray(want.data))
