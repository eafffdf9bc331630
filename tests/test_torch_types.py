"""The port's own video types equal the reference's.

``ultragrid_tpu_torch.types`` copies what the port uses of
``ultragrid_tpu/types.py`` so that the port imports nothing of the JAX
package; these tests hold every copied value to the reference's.
"""

import dataclasses

import pytest

pytest.importorskip("torch")

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
