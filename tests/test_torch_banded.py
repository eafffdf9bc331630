"""The live session's JPEG encode and decode split by row band over the cards
that ``--param cuda-device`` names (``parallel/sharded_jpeg.py`` under
``modules/video_compress.py`` ``JpegCompress`` and
``modules/video_decompress.py`` ``JpegDecompress``), on the CPU, where the
param's list maps to as many CPU entries.

The band split is invisible on the wire and on the screen: the banded file
equals the one-device ``JpegEncoder``'s file at the bands' restart interval
byte for byte, and the banded decode equals the one-device decode bit for
bit.  The card's rows of the same checks are ``chip_smoke.py``'s
``banded_session``.
"""

import numpy as np
import pytest
import torch

from ultragrid_tpu_torch import _build, cli
from ultragrid_tpu_torch.modules.video_compress import JpegCompress
from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress
from ultragrid_tpu_torch.ops import jpeg
from ultragrid_tpu_torch.ops import jpeg_decode_cuda as jd
from ultragrid_tpu_torch.parallel import mesh as mesh_mod
from ultragrid_tpu_torch.ops import jpeg_assemble_cuda
from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedJpegDecoder, ShardedJpegEncoder
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, vc_get_linesize
from ultragrid_tpu_torch.utils import params, profiler

BANDS = 4


@pytest.fixture
def cards():
    """``--param cuda-device`` set to four cards for the test, the params as
    they were after it."""
    saved = dict(params._values)
    params.set_commandline_param("cuda-device", ",".join(str(i) for i in range(BANDS)))
    yield
    params._values.clear()
    params._values.update(saved)


@pytest.fixture
def trace():
    """The profiler on, its records cleared before and after."""
    saved = profiler.enabled
    profiler.enabled = True
    profiler._events.clear()
    yield profiler._events
    profiler.enabled = saved
    profiler._events.clear()


def uyvy(w, h, seed, noise=False):
    ls = vc_get_linesize(w, Codec.UYVY)
    rng = np.random.default_rng(seed)
    if noise:
        return rng.integers(0, 256, (h, ls), dtype=np.uint8)
    base = np.linspace(0, 255, ls, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, ls))
    return base.clip(16, 235).astype(np.uint8)


def frame_of(data, w, h, codec=Codec.UYVY):
    f = VideoFrame(VideoDesc(w, h, codec, 24.0), [data])
    f.timestamp = 1.0
    return f


def compress(module, pixels, w, h) -> np.ndarray:
    return np.asarray(module.compress(frame_of(torch.as_tensor(pixels), w, h)).data)


# (width, height, compress spec, segments a band); 45 and 15 are no
# multiple of 8, so the bands' restart markers are numbered on
GEOMETRIES = [(256, 64, "jpeg:80", 32), (240, 96, "jpeg:80", 45), (240, 96, "jpeg:85:3", 15),
              (1024, 512, "jpeg:80", 512)]


@pytest.mark.parametrize("w,h,spec,nseg", GEOMETRIES)
def test_banded_compress_gives_the_one_device_file(cards, w, h, spec, nseg):
    mod = JpegCompress(spec.partition(":")[2], device="cpu")
    assert mod.mesh is not None and len(mod.mesh.spatial) == BANDS
    pixels = uyvy(w, h, w + h)
    got = compress(mod, pixels, w, h)
    enc = next(iter(mod._encoders.values()))
    assert isinstance(enc, ShardedJpegEncoder) and enc.nshards == BANDS and enc.local.nseg == nseg
    ri = enc.local.restart_interval
    if spec.count(":") == 2:
        assert ri == int(spec.split(":")[2])
    one = jpeg.JpegEncoder(w, h, quality=enc.local.quality, restart_interval=ri).encode(pixels, device="cpu")
    assert np.array_equal(got, one)
    mod.done()


@pytest.mark.parametrize("w,h,ri", [(240, 96, None), (256, 64, 2)])
def test_banded_file_is_the_one_card_file_on_the_device(cards, w, h, ri):
    """The banded encoder's file stays a tensor on the frame's device, and
    equals the one-card encoder's tensor file and its C file."""
    from ultragrid_tpu_torch.device import DeviceFile

    pixels = torch.as_tensor(uyvy(w, h, 12))
    enc = ShardedJpegEncoder(w, h, mesh_mod.mesh_from_param("cpu"), restart_interval=ri)
    got = enc.encode_file(pixels)
    one = jpeg.JpegEncoder(w, h, restart_interval=enc.local.restart_interval)
    assert isinstance(got, DeviceFile) and got.device == pixels.device
    assert torch.equal(got, one.encode_file(pixels)) and np.array_equal(np.asarray(got), one.encode(pixels))
    assert np.array_equal(enc.encode(pixels), np.asarray(got))


def test_banded_compress_escalates_each_band_and_stays_equal(cards):
    w, h = 256, 128
    mod = JpegCompress("95", device="cpu")
    compress(mod, uyvy(w, h, 1), w, h)
    enc = next(iter(mod._encoders.values()))
    enc.local.wwords = 2
    noise = uyvy(w, h, 2, noise=True)
    got = compress(mod, noise, w, h)
    assert enc.local.wwords > 2
    one = jpeg.JpegEncoder(w, h, quality=95, restart_interval=enc.local.restart_interval)
    assert np.array_equal(got, one.encode(noise, device="cpu"))
    mod.done()


@pytest.mark.parametrize("value", [None, "0", "3"])
def test_one_card_or_none_keeps_the_one_device_path(value):
    saved = dict(params._values)
    try:
        if value is not None:
            params.set_commandline_param("cuda-device", value)
        assert mesh_mod.mesh_from_param("cpu") is None
        mod = JpegCompress("", device="cpu")
        compress(mod, uyvy(64, 32, 3), 64, 32)
        assert mod.mesh is None and type(next(iter(mod._encoders.values()))) is jpeg.JpegEncoder
        assert JpegDecompress("cpu").banded is None
    finally:
        params._values.clear()
        params._values.update(saved)


def test_the_param_maps_to_cpu_entries_and_is_checked(cards):
    mesh = mesh_mod.mesh_from_param("cpu")
    assert mesh.spatial == [torch.device("cpu")] * BANDS
    assert mesh_mod.cuda_device_list("2,0") == [2, 0] and mesh_mod.cuda_device_list(None) == []
    for bad in ("0,x", "-1,0", "0;1"):
        with pytest.raises(ValueError, match="cuda-device"):
            mesh_mod.cuda_device_list(bad)


@pytest.mark.parametrize("w,h,ri", [(256, 64, None), (240, 96, 3), (256, 128, None), (1024, 512, None)])
def test_banded_decompress_gives_the_one_device_frame(cards, w, h, ri):
    data = jpeg.JpegEncoder(w, h, quality=85, restart_interval=ri).encode(uyvy(w, h, 5), device="cpu")
    banded = JpegDecompress("cpu")
    assert isinstance(banded.banded, ShardedJpegDecoder) and banded.banded.nshards == BANDS
    got = banded.decompress(frame_of(data, w, h, Codec.JPEG), Codec.UYVY).data
    params._values.pop("cuda-device")
    one = JpegDecompress("cpu")
    assert one.banded is None
    want = one.decompress(frame_of(data, w, h, Codec.JPEG), Codec.UYVY).data
    assert got.shape == (h, 2 * w) and torch.equal(got, want)


def test_a_stream_the_bands_cannot_take_gets_the_one_device_decode(cards):
    # 3 MCU rows over 4 bands; then 5 segments of 8 MCUs over 4 bands of 10
    for w, h, ri in ((64, 24, None), (80, 32, 8)):
        data = bytes(jpeg.JpegEncoder(w, h, restart_interval=ri).encode(uyvy(w, h, 6), device="cpu"))
        dec = ShardedJpegDecoder(mesh_mod.mesh_from_param("cpu"), "cpu")
        got, dh, dw = dec.decode_frame(data)
        assert (dh, dw) == (h, w) and torch.equal(got, jpeg.JpegDecoder("cpu").decode_to_uyvy(data)[0])
        bands, _, _ = dec.decode_to_uyvy(data)
        assert len(bands) == 1


def corrupt_band(data: bytes, band: int, nbands: int) -> bytes:
    """``data`` with the first bytes of band ``band``'s first restart
    segment set to stuffed 0xFF bytes: a run of 1-bits that no Huffman code
    of the scan holds."""
    hdr = jpeg._parse_headers(data)
    nmcu = ((hdr["w"] + 15) // 16) * ((hdr["h"] + 7) // 8)
    first_seg = band * (nmcu // nbands) // hdr["ri"]
    buf = bytearray(data)
    pos = hdr["scan_start"]
    for _ in range(first_seg):  # past that many RST markers
        pos = next(i for i in range(pos, len(buf) - 1) if buf[i] == 0xFF and buf[i + 1] & 0xF8 == 0xD0) + 2
    buf[pos: pos + 4] = b"\xff\x00\xff\x00"
    return bytes(buf)


def test_a_corrupt_segment_range_is_refused_as_by_the_one_device_decode(cards):
    w, h = 256, 64
    data = corrupt_band(bytes(jpeg.JpegEncoder(w, h).encode(uyvy(w, h, 7), device="cpu")), 2, BANDS)
    dec = ShardedJpegDecoder(mesh_mod.mesh_from_param("cpu"), "cpu")
    refused = jd.REFUSED.count
    with pytest.raises(ValueError, match="stopped"):
        dec.decode_frame(data)
    with pytest.raises(ValueError, match="stopped"):
        dec.decode_to_uyvy(data)
    assert jd.REFUSED.count == refused + 2
    with pytest.raises(ValueError):  # the one-device decode: the C path on the CPU
        jpeg.JpegDecoder("cpu").decode_to_uyvy(data)
    one = jpeg.JpegDecoder("cpu")
    one._card = True  # its card route, the plain version in the kernel's place
    with pytest.raises(ValueError, match="stopped"):
        one.decode_to_uyvy(data)


@pytest.mark.parametrize("w,h,ri,bands", [(256, 64, None, 4), (240, 96, 3, 4), (256, 128, 2, 2)])
def test_a_segment_range_decodes_to_the_rows_of_the_whole_scan(w, h, ri, bands):
    data = bytes(jpeg.JpegEncoder(w, h, restart_interval=ri).encode(uyvy(w, h, 8), device="cpu"))
    hdr = jpeg._parse_headers(data)
    nmcu = ((hdr["w"] + 15) // 16) * ((hdr["h"] + 7) // 8)
    file = torch.zeros(len(data) + jd.PAD, dtype=torch.uint8)
    file[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    tables = torch.as_tensor(jd.huffman_tables(hdr["htabs"]))
    tds = tuple(c["td"] for c in hdr["scan"])
    whole, status = jd.segment_decode(file, len(data), hdr["scan_start"], tables, tds, nmcu, hdr["ri"])
    nseg = -(-nmcu // hdr["ri"])
    assert status.tolist() == [0, nmcu, nseg - 1, 0]
    step = nseg // bands
    for b in range(bands):
        seg0, seg1 = b * step, (b + 1) * step
        q, st = jd.segment_decode(file, len(data), hdr["scan_start"], tables, tds, nmcu, hdr["ri"],
                                  segments=(seg0, seg1))
        m0, m1 = seg0 * hdr["ri"], min(seg1 * hdr["ri"], nmcu)
        assert st.tolist() == [0, m1 - m0, nseg - 1, 0] and torch.equal(q, whole[m0:m1])
    for bad in ((0, 0), (-1, 2), (1, nseg + 1)):
        with pytest.raises(ValueError, match="segments"):
            jd.segment_decode(file, len(data), hdr["scan_start"], tables, tds, nmcu, hdr["ri"], segments=bad)


@pytest.mark.parametrize("first", [2 * 2025, 16, 3])
def test_a_band_numbers_its_markers_in_the_frame(first):
    """A band's body from the assembly that starts at segment ``first`` of
    the frame: the marker before its first segment, then the one-band C
    body with each marker counted on by ``first`` (mod 8)."""
    enc = jpeg.JpegEncoder(256, 64, restart_interval=4)
    parts = enc.encode_plain(torch.as_tensor(uyvy(256, 64, 4)))
    c_body = enc.assemble(*parts[:-1])
    got = jpeg_assemble_cuda.assemble_plain(*parts[:-1], ky=enc.ky, restart_interval=4, first_segment=first)
    ff = np.flatnonzero(c_body[:-1] == 0xFF) + 1
    at = ff[(c_body[ff] & 0xF8) == 0xD0]
    assert at.size == enc.nseg - 1
    want = c_body.copy()
    want[at] = 0xD0 | ((want[at] + first % 8) & 7)
    lead = [0xFF, 0xD0 + (first - 1) % 8]
    assert got.tolist() == lead + want.tolist()
    assert jpeg_assemble_cuda.assemble_plain(*parts[:-1], ky=enc.ky, restart_interval=4).tolist() == c_body.tolist()


def test_the_banded_path_records_its_spans(cards, trace):
    w, h = 256, 64
    mod = JpegCompress("", device="cpu")
    with profiler.zone("compress", frame=77):
        data = compress(mod, uyvy(w, h, 9), w, h)
    dec = JpegDecompress("cpu")
    with profiler.zone("rx.decompress", frame=77):
        dec.decompress(frame_of(data, w, h, Codec.JPEG), Codec.UYVY)
    mod.done()
    recs = list(trace)
    names = [r[0] for r in recs]
    assert names.count("compress.split") == 1 and names.count("compress.band") == BANDS
    for child in ("compress.k1", "compress.assemble"):
        inner = [r for r in recs if r[0] == child]
        assert len(inner) == BANDS and all(r.parent == "compress.band" for r in inner), child
    assert all(r.frame == 77 for r in recs if r[0].startswith("compress."))
    assert names.count("decompress.band") == BANDS and names.count("decompress.gather") == 1
    assert all(r.parent == "decompress.band" for r in recs if r[0] == "decompress.scan")


def test_launch_counter_counts_per_card():
    c = _build.LaunchCounter("k")
    for i in (0, 1, 1, 3):
        c.add(torch.device("cuda", i))
    c.add(torch.device("cpu"))
    assert c.count == 5 and c.per_device == {0: 1, 1: 2, 3: 1, None: 1}
    c.reset()
    assert c.count == 0 and c.per_device == {}


def test_cli_cuda_device(capsys):
    saved = dict(params._values)
    try:
        assert cli.main(["--cuda-device", "help"]) == 0
        assert "CUDA devices:" in capsys.readouterr().out
        assert cli.main(["--cuda-device", "0,1,2,3", "-L"]) == 0
        assert params.get_commandline_param("cuda-device") == "0,1,2,3"
        assert "--param cuda-device" in capsys.readouterr().out
        assert cli.main(["--cuda-device", "0,x", "-L"]) == 1
    finally:
        params._values.clear()
        params._values.update(saved)
