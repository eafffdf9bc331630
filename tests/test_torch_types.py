"""The port's own video types equal the reference's.

``ultragrid_tpu_torch.types`` copies what the port uses of
``ultragrid_tpu/types.py`` so that the port imports nothing of the JAX
package; these tests hold every copied value to the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ultragrid_tpu import types as ref_types  # noqa: E402
from ultragrid_tpu_torch import types as port_types  # noqa: E402

CODECS = [c.name for c in port_types.Codec]


@pytest.mark.parametrize("name", CODECS)
def test_codec_value(name):
    assert int(port_types.Codec[name]) == int(ref_types.Codec[name])


@pytest.mark.parametrize("name", [c.name for c in port_types.InterlacingType])
def test_interlacing_value(name):
    assert int(port_types.InterlacingType[name]) == int(ref_types.InterlacingType[name])


@pytest.mark.parametrize("name", ["RGBA", "UYVY", "YUYV", "RGB"])
def test_linesize(name):
    for width in (1, 2, 3, 7, 8, 16, 64, 1918, 1920, 3840, 7680):
        assert port_types.vc_get_linesize(width, port_types.Codec[name]) == \
            ref_types.vc_get_linesize(width, ref_types.Codec[name])


def test_linesize_of_a_codec_without_lines_raises():
    with pytest.raises(ValueError, match="JPEG"):
        port_types.vc_get_linesize(64, port_types.Codec.JPEG)


def test_video_desc_fields():
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port_types.VideoDesc)]
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref_types.VideoDesc)]
    assert port_fields == ref_fields
    p = port_types.VideoDesc(1920, 1080, port_types.Codec.UYVY, 60.0)
    r = ref_types.VideoDesc(1920, 1080, ref_types.Codec.UYVY, 60.0)
    assert dataclasses.astuple(p) == dataclasses.astuple(r)
    assert p.linesize() == r.linesize()
    q = p.with_(color_spec=port_types.Codec.JPEG)
    assert q.color_spec == port_types.Codec.JPEG and q.width == 1920


def test_video_frame():
    desc = port_types.VideoDesc(64, 32, port_types.Codec.RGB)
    f = port_types.VideoFrame(desc, ["tile"], timestamp=2.0)
    assert f.data == "tile" and f.timestamp == 2.0 and f.desc is desc
    assert port_types.VideoFrame(desc).timestamp == ref_types.VideoFrame(desc).timestamp


ALL_CODECS = [c.name for c in ref_types.Codec]


def test_codec_set_is_the_reference_set():
    assert [(c.name, int(c)) for c in port_types.Codec] == [(c.name, int(c)) for c in ref_types.Codec]
    assert [(s.name, int(s)) for s in port_types.Subsampling] == \
        [(s.name, int(s)) for s in ref_types.Subsampling]


@pytest.mark.parametrize("name", ALL_CODECS)
def test_codec_info(name):
    p = port_types.get_codec_info(port_types.Codec[name])
    r = ref_types.get_codec_info(ref_types.Codec[name])
    assert dataclasses.astuple(p)[:-2] == dataclasses.astuple(r)[:-2]
    assert int(p.subsampling) == int(r.subsampling) and p.file_extension == r.file_extension
    assert p.rgb == r.rgb and p.opaque == r.opaque
    codec_p, codec_r = port_types.Codec[name], ref_types.Codec[name]
    assert port_types.get_bits_per_component(codec_p) == ref_types.get_bits_per_component(codec_r)
    assert port_types.codec_is_a_rgb(codec_p) == ref_types.codec_is_a_rgb(codec_r)


@pytest.mark.parametrize("name", [n for n in ALL_CODECS if not ref_types.is_codec_opaque(ref_types.Codec[n])])
def test_linesize_of_every_pixel_format(name):
    for width in (1, 2, 6, 8, 48, 64, 192, 1918, 1920, 3840, 7680):
        assert port_types.vc_get_linesize(width, port_types.Codec[name]) == \
            ref_types.vc_get_linesize(width, ref_types.Codec[name])


@pytest.mark.parametrize("name", ALL_CODECS)
def test_codec_from_name(name):
    info_name = ref_types.get_codec_info(ref_types.Codec[name]).name
    for spelled in (info_name, info_name.lower(), info_name.upper()):
        assert int(port_types.get_codec_from_name(spelled)) == int(ref_types.get_codec_from_name(spelled))
    assert port_types.get_codec_from_name("no such codec") == port_types.Codec.NONE


@pytest.mark.parametrize("name", [n for n in ALL_CODECS if n != "NONE"])
def test_datalen_and_alloc(name):
    for w, h in ((64, 32), (1920, 1080), (50, 30)):
        p = port_types.VideoDesc(w, h, port_types.Codec[name], tile_count=2)
        r = ref_types.VideoDesc(w, h, ref_types.Codec[name], tile_count=2)
        assert p.datalen() == r.datalen()
        got, want = port_types.VideoFrame.alloc(p, "cpu"), ref_types.VideoFrame.alloc(r)
        assert len(got.tiles) == len(want.tiles) == 2
        for g, t in zip(got.tiles, want.tiles):
            assert tuple(g.shape) == t.shape and g.dtype == torch.uint8 and g.device.type == "cpu"
            assert not g.any()


DESCS = [(1920, 1080, "UYVY", 60.0, "PROGRESSIVE"), (3840, 2160, "v210", 59.94, "INTERLACED_MERGED"),
         (720, 576, "RGB", 25.0, "UPPER_FIELD_FIRST"), (640, 480, "I420", 29.97, "LOWER_FIELD_FIRST"),
         (1280, 720, "JPEG", 23.976, "SEGMENTED_FRAME"), (64, 32, "H265", 120.0, "PROGRESSIVE")]


@pytest.mark.parametrize("w,h,codec,fps,interl", DESCS)
def test_video_desc_str_and_parse(w, h, codec, fps, interl):
    p = port_types.VideoDesc(w, h, port_types.Codec[codec], fps, port_types.InterlacingType[interl])
    r = ref_types.VideoDesc(w, h, ref_types.Codec[codec], fps, ref_types.InterlacingType[interl])
    assert str(p) == str(r)
    back, ref_back = port_types.VideoDesc.parse(str(p)), ref_types.VideoDesc.parse(str(r))
    assert dataclasses.astuple(back) == dataclasses.astuple(ref_back)
    with pytest.raises(ValueError):
        port_types.VideoDesc.parse("64x32 @30x, codec UYVY")


@pytest.mark.parametrize("s", ["29.97", "30000/1001", "60", "23.98", "59.94", "25", "24000/1001",
                               "12.5", "47.952", "0.5", "119.88"])
def test_parse_fps(s):
    assert port_types.parse_fps(s) == ref_types.parse_fps(s)


def test_video_frame_fields_setter_and_copy():
    desc = port_types.VideoDesc(64, 32, port_types.Codec.UYVY)
    p, r = port_types.VideoFrame(desc), ref_types.VideoFrame(desc)
    for name in ("timestamp", "compress_start", "compress_end", "callbacks"):
        assert getattr(p, name) == getattr(r, name)
    assert set(port_types.VideoFrame.__slots__) == set(ref_types.VideoFrame.__slots__)
    data = torch.arange(64 * 32 * 2, dtype=torch.int32).to(torch.uint8).reshape(32, 128)
    p.data = data  # appends the first tile
    assert p.tiles == [data]
    other = data.flip(0)
    p.data = other  # replaces it
    assert len(p.tiles) == 1 and p.data is other
    p.timestamp, p.callbacks["ssrc"] = 3.5, 9
    c = p.copy()
    assert c.desc is desc and c.timestamp == 3.5 and c.callbacks == {}
    assert torch.equal(c.data, other) and c.data.data_ptr() != other.data_ptr()
    np_frame = port_types.VideoFrame(desc, [np.zeros((32, 128), np.uint8)]).copy()
    assert isinstance(np_frame.data, np.ndarray)


@pytest.mark.parametrize("name", ALL_CODECS)
def test_codec_helpers(name):
    """get_bpp / CodecInfo.bpp, get_subsampling, is_codec_interframe,
    codec_is_const_size, codec_get_planes_subsampling and vc_get_size equal
    the reference's for every codec (vc_get_size at several widths)."""
    cp, cr = port_types.Codec[name], ref_types.Codec[name]
    assert port_types.get_bpp(cp) == ref_types.get_bpp(cr) == port_types.get_codec_info(cp).bpp
    assert port_types.get_subsampling(cp) == ref_types.get_subsampling(cr)
    assert port_types.is_codec_interframe(cp) == ref_types.is_codec_interframe(cr)
    assert port_types.codec_is_const_size(cp) == ref_types.codec_is_const_size(cr)
    assert port_types.codec_get_planes_subsampling(cp) == ref_types.codec_get_planes_subsampling(cr)
    for width in (0, 1, 2, 6, 7, 8, 48, 64, 1918, 1920, 3840, 7680):
        assert port_types.vc_get_size(width, cp) == ref_types.vc_get_size(width, cr)


def test_constants_all_and_top_level_exports():
    assert port_types.__all__ == ref_types.__all__
    assert all(hasattr(port_types, n) for n in port_types.__all__)
    assert (port_types.MAX_PADDING, port_types.KHZ_90, port_types.PIX_BLOCK_LCM) == \
        (ref_types.MAX_PADDING, ref_types.KHZ_90, ref_types.PIX_BLOCK_LCM)
    import ultragrid_tpu
    import ultragrid_tpu_torch

    for name in ("get_bpp", "vc_get_size", "vc_get_datalen", "get_bits_per_component", "InterlacingType"):
        assert getattr(ultragrid_tpu_torch, name) is getattr(port_types, name)
        assert hasattr(ultragrid_tpu, name)
