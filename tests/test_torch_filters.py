"""The port's filters (``modules/filters.py``) against the JAX package's, on the CPU.

Every name of the reference's ``_FILTERS`` runs through a reference
``FilterChain`` and a port ``FilterChain`` on the same testcard frames; the
outputs (None, one frame or a list), their descriptions and their bytes must
be equal.  Tolerance: byte-equal, except ``noise``, whose draws come from a
torch generator (``jax.random`` cannot be reproduced): its output is held to
the contract of ``add_noise`` (within ±amount, the same bytes for the same
seed).  Fan-out (double_framerate) and consumption (every, delay,
temporal_3d) are driven as ``tests/test_filters.py`` drives them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ultragrid_tpu.modules import filters as ref_filters  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import InterlacingType as RefInterlacing  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402
from ultragrid_tpu.utils.pattern import generate_pattern as ref_pattern  # noqa: E402
from ultragrid_tpu_torch.modules import filters  # noqa: E402
from ultragrid_tpu_torch.modules.registry import LibraryClass, list_modules, load_library  # noqa: E402
from ultragrid_tpu_torch.types import Codec, InterlacingType, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils.tiling import vf_merge_tiles  # noqa: E402

W, H = 192, 128
PATTERNS = ["bars", "gradient", "smpte_bars", "noise"]


def frames(codec="UYVY", n=1, w=W, h=H, interlacing="PROGRESSIVE"):
    """n (reference, port) frame pairs of one codec, each another pattern."""
    out = []
    for i in range(n):
        data = np.asarray(ref_pattern(w, h, RefCodec[codec], PATTERNS[i % len(PATTERNS)], seed=i))
        rf = RefFrame(RefDesc(w, h, RefCodec[codec], 30.0, RefInterlacing[interlacing]), [jnp.asarray(data)])
        pf = VideoFrame(VideoDesc(w, h, Codec[codec], 30.0, InterlacingType[interlacing]), [torch.tensor(data)])
        rf.timestamp = pf.timestamp = 1.5 + i
        out.append((rf, pf))
    return out


def desc_tuple(d):
    return (d.width, d.height, int(d.color_spec), d.fps, int(d.interlacing), d.tile_count)


def as_list(r):
    return [] if r is None else r if isinstance(r, list) else [r]


def assert_same(ref_out, port_out):
    ro, po = as_list(ref_out), as_list(port_out)
    assert len(ro) == len(po)
    assert isinstance(ref_out, list) == isinstance(port_out, list)
    for r, p in zip(ro, po):
        assert desc_tuple(p.desc) == desc_tuple(r.desc)
        assert p.timestamp == r.timestamp and len(p.tiles) == len(r.tiles)
        for rt, pt in zip(r.tiles, p.tiles):
            assert isinstance(pt, torch.Tensor) and pt.device.type == "cpu"
            want = np.asarray(rt)
            assert pt.dtype == torch.uint8 and tuple(pt.shape) == want.shape
            assert int((pt.numpy() != want).sum()) == 0


def run_both(spec, pairs):
    rc, pc = ref_filters.FilterChain(spec), filters.FilterChain(spec)
    for rf, pf in pairs:
        assert_same(rc.apply(rf), pc.apply(pf))
    return rc, pc


CASES = [
    ("scale:96x64", "UYVY", 2),
    ("resize:96:64", "RGB", 1),
    ("deinterlace", "UYVY", 2),
    ("deinterlace:linear", "v210", 1),
    ("deinterlace:bob", "RGB", 1),
    ("deinterlace_blend", "v210", 1),
    ("deinterlace_linear", "UYVY", 1),
    ("deinterlace_bob", "UYVY", 1),
    ("interlace", "UYVY", 1),
    ("crop:64:32:16:8", "UYVY", 1),
    ("crop:50:20", "RGB", 1),
    ("mirror", "UYVY", 2),
    ("mirror", "RGBA", 1),
    ("flip", "UYVY", 1),
    ("gamma:2.2", "RGB", 2),
    ("gamma", "RGBA", 1),
    ("grayscale", "UYVY", 1),
    ("grayscale", "RGB", 2),
    ("matrix:0.393:0.769:0.189:0.349:0.686:0.168:0.272:0.534:0.131", "RGB", 2),
    ("blank:8:8:32:16", "UYVY", 1),
    ("blank", "RGB", 1),
    ("every:3", "UYVY", 7),
    ("disrupt:drop=50", "UYVY", 8),
    ("disrupt:jitter=1", "UYVY", 2),
    ("change_pixfmt:RGB", "UYVY", 1),
    ("change_pixfmt:v210", "UYVY", 1),
    ("border:color=ff0000:width=8:height=6", "UYVY", 1),
    ("border", "RGB", 1),
    ("border:width=12", "R10k", 1),
    ("split:2x2", "UYVY", 1),
    ("delay:frames=3", "UYVY", 6),
    ("double_framerate", "UYVY", 1),
    ("temporal_deint:force", "UYVY", 1),
    ("text:x=10:y=10:h=8:t=HELLO", "RGBA", 1),
    ("text:x=4:y=100:h=16:t=UltraGrid", "UYVY", 1),
    ("add_frame:every=5", "UYVY", 10),
    ("matrix2:y601_to_y709", "UYVY", 2),
    ("matrix2:1:0:0:0:1:0:0:0:1", "UYVY", 1),
    ("matrix2:y601_to_y709", "RGB", 1),
    ("override_prop:fps=59.94:size=640x480", "UYVY", 1),
    ("override_prop:codec=YUYV", "UYVY", 1),
    ("override_prop:fps=50i", "UYVY", 1),
    ("color", "UYVY", 2),
    ("color", "v210", 1),
    ("temporal_3d", "UYVY", 4),
    ("display:dummy", "UYVY", 2),
    ("preview", "UYVY", 1),
]


@pytest.mark.parametrize("spec,codec,n", CASES, ids=[f"{s}-{c}" for s, c, _ in CASES])
def test_filter_equals_reference(spec, codec, n):
    run_both(spec, frames(codec, n))


def test_interlaced_inputs():
    for spec in ("double_framerate", "temporal_deint", "deinterlace", "interlace,deinterlace:bob"):
        run_both(spec, frames("UYVY", 2, interlacing="INTERLACED_MERGED"))


def test_logo_filter(tmp_path):
    logo = np.random.default_rng(1).integers(0, 256, (20, 24, 4), dtype=np.uint8)
    path = tmp_path / "logo.npy"
    np.save(path, logo)
    run_both(f"logo:{path}:5:7", frames("RGB", 2))
    run_both("logo", frames("RGBA", 1))


def test_interlaced_3d_and_temporal_3d():
    run_both("temporal_3d,interlaced_3d", frames("UYVY", 4))
    run_both("temporal_3d,3d-interlaced", frames("RGB", 2))
    run_both("interlaced_3d", frames("UYVY", 1))  # one tile: passes through


def test_border_without_a_conversion_raises_as_the_reference():
    (rf, pf), = frames("v210", 1)
    with pytest.raises(ValueError, match="RGBA -> v210"):
        ref_filters.FilterChain("border").apply(rf)
    with pytest.raises(ValueError, match="RGBA -> v210"):
        filters.FilterChain("border").apply(pf)


def test_ratelimit():
    rc, pc = ref_filters.FilterChain("ratelimit:1"), filters.FilterChain("ratelimit:1")
    (rf, pf), (rf2, pf2) = frames("UYVY", 2)
    assert_same(rc.apply(rf), pc.apply(pf))
    assert rc.apply(rf2) is None and pc.apply(pf2) is None


def test_noise_contract():
    pairs = frames("UYVY", 3)
    a, b = filters.FilterChain("noise:16"), filters.FilterChain("noise:16")
    for _, pf in pairs:
        x, y = a.apply(pf), b.apply(pf)
        src = pf.data.to(torch.int32)
        d = x.data.to(torch.int32) - src
        assert x.data.dtype == torch.uint8 and x.data.shape == pf.data.shape
        assert int(d.abs().max()) <= 16 and torch.equal(x.data, y.data)
        assert desc_tuple(x.desc) == desc_tuple(pf.desc) and x.timestamp == pf.timestamp
    # one generator per filter: the next frame draws new noise
    c = filters.FilterChain("noise")
    assert not torch.equal(c.apply(pairs[0][1]).data, c.apply(pairs[0][1]).data)
    assert c.filters[0].amount == 16


def test_chain_fan_out_and_consumption():
    run_both("scale:96x64,grayscale,flip", frames("UYVY", 2))
    run_both("every:2,scale:96x64", frames("UYVY", 5))
    run_both("double_framerate,flip", frames("UYVY", 2, interlacing="INTERLACED_MERGED"))
    run_both("add_frame:every=2,mirror,every:3", frames("UYVY", 6))
    run_both("delay:frames=2,border", frames("UYVY", 4))
    assert filters.FilterChain("").apply(None) is None
    assert filters.FilterChain("flip").apply(None) is None


def test_split_merges_back():
    (_, pf), = frames("UYVY", 1)
    out = filters.FilterChain("split:2x2").apply(pf)
    assert out.desc.tile_count == 4
    assert torch.equal(vf_merge_tiles(out, 2, 2).data, pf.data)


def test_display_tee_counts_frames():
    chain = filters.FilterChain("display:dummy")
    (_, pf), = frames("UYVY", 1)
    assert chain.apply(pf) is pf
    assert chain.filters[0].display.frames_shown == 1
    chain.filters[0].done()


def test_preview_passes_through():
    (_, pf), = frames("UYVY", 1)
    chain = filters.FilterChain("preview")
    assert chain.apply(pf) is pf and chain.filters[0].display is None


def test_filters_do_not_write_their_input():
    (_, pf), = frames("UYVY", 1)
    before = pf.data.clone()
    for spec in ("border", "blank", "text:t=X", "grayscale", "deinterlace", "mirror"):
        filters.FilterChain(spec).apply(pf)
    assert torch.equal(pf.data, before)


def test_bad_specs_raise():
    for spec in ("definitely_not_a_filter", "matrix:1:2", "matrix2:1", "change_pixfmt:nope",
                 "delay:3", "override_prop:bogus=1", "deinterlace:weird"):
        with pytest.raises(ValueError):
            filters.FilterChain(spec).apply(frames("UYVY", 1)[0][1])


def test_every_name_registered_in_both_roles():
    assert sorted(filters._FILTERS) == sorted(ref_filters._FILTERS)
    for role in (LibraryClass.CAPTURE_FILTER, LibraryClass.VO_POSTPROCESS):
        assert list_modules(role) == sorted(ref_filters._FILTERS)
        assert load_library("mirror", role) is filters.MirrorFilter
