"""The port's local loop against the JAX package's, on the CPU.

Test patterns, the testcard and its grammar, the displays, tiling,
``run_local_pipeline`` with capture filters and postprocess, the extra
displays, the stitcher, the registry and the capabilities, each driven the
same way through the reference and through the port (``device="cpu"``).
Tolerance: byte-equal frames, equal descriptions and equal files; the
stitcher's float32 blend included (0 differing bytes: the port rounds as
XLA's CPU compile of the reference's blend).
"""

import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules import registry as ref_registry  # noqa: E402
from ultragrid_tpu.modules import video_capture as ref_capture  # noqa: E402
from ultragrid_tpu.modules import video_display as ref_display  # noqa: E402
from ultragrid_tpu.modules.extra_displays import register_pipe_delegate as ref_register_pipe  # noqa: E402
from ultragrid_tpu.pipeline import loop as ref_loop  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402
from ultragrid_tpu.utils import tiling as ref_tiling  # noqa: E402
from ultragrid_tpu.utils.capabilities import get_capabilities as ref_capabilities  # noqa: E402
from ultragrid_tpu.utils.pattern import generate_pattern as ref_pattern  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch.modules import registry  # noqa: E402
from ultragrid_tpu_torch.modules import video_capture, video_display  # noqa: E402
from ultragrid_tpu_torch.modules.extra_displays import BlendDisplay, PanoDisplay, register_pipe_delegate  # noqa: E402
from ultragrid_tpu_torch.pipeline import loop  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import tiling  # noqa: E402
from ultragrid_tpu_torch.utils.capabilities import get_capabilities, print_capabilities  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

PATTERNS = ["bars", "ebu_bars", "smpte_bars", "blank", "blank=0xFF336699", "gray", "uv_plane",
            "gradient", "gradient=0x4080", "gradient2", "gradient2=1000", "noise"]
TESTCARD_CODECS = ["UYVY", "YUYV", "RGB", "RGBA", "v210", "R10k", "R12L", "RG48", "Y216", "Y416", "VUYA"]


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bytes(port_data, ref_data):
    got, want = host(port_data), host(ref_data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int((got != want).sum()) == 0


def desc_tuple(d):
    return (d.width, d.height, int(d.color_spec), d.fps, int(d.interlacing), d.tile_count)


# ---- patterns and the testcard ----


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("codec", ["UYVY", "RGB"])
def test_pattern_equals_reference(pattern, codec):
    got = generate_pattern(96, 40, Codec[codec], pattern, device="cpu")
    assert isinstance(got, torch.Tensor)
    assert_bytes(got, ref_pattern(96, 40, RefCodec[codec], pattern))


@pytest.mark.parametrize("codec", TESTCARD_CODECS)
@pytest.mark.parametrize("pattern", ["bars", "noise"])
def test_pattern_every_testcard_codec(codec, pattern):
    assert_bytes(generate_pattern(96, 40, Codec[codec], pattern, seed=3, device="cpu"),
                 ref_pattern(96, 40, RefCodec[codec], pattern, seed=3))


@pytest.mark.parametrize("codec", ["BGR", "I420"])
def test_pattern_without_a_conversion_raises(codec):
    with pytest.raises(ValueError, match="cannot convert"):
        ref_pattern(64, 32, RefCodec[codec])
    with pytest.raises(ValueError, match="cannot convert"):
        generate_pattern(64, 32, Codec[codec], device="cpu")
    with pytest.raises(ValueError, match="unknown pattern"):
        generate_pattern(64, 32, Codec.UYVY, "nope", device="cpu")


@pytest.mark.parametrize("spec", [
    "testcard:s=96x64:f=1000:c=UYVY",
    "testcard:96:64:1000:RGB",
    "testcard:size=96x64:fps=1000p:codec=v210:pattern=smpte_bars",
    "testcard:s=96x64:f=1000:c=UYVY:still=1",
    "testcard:s=96x64:f=1000:c=RGBA:p=gradient",
    "noise:s=96x64:f=1000:c=UYVY",
])
def test_testcard_ring_equals_reference(spec):
    ref_cap = ref_capture.initialize_video_capture(spec)
    cap = video_capture.initialize_video_capture(spec, device="cpu")
    inner = getattr(ref_cap, "inner", ref_cap)  # the reference's NoiseCapture wraps a testcard
    assert desc_tuple(cap.desc) == desc_tuple(inner.desc)
    ring = len(inner.frames)
    for _ in range(ring + 2):  # around the ring
        (f, a), (rf, ra) = cap.grab(), ref_cap.grab()
        assert a is None and ra is None
        assert desc_tuple(f.desc) == desc_tuple(rf.desc)
        assert f.data.device.type == "cpu"
        assert_bytes(f.data, rf.data)
    cap.done()
    ref_cap.done()


def test_testcard_defaults_and_grammar():
    cap = video_capture.initialize_video_capture("testcard", device="cpu")
    assert (cap.desc.width, cap.desc.height, cap.desc.color_spec, cap.desc.fps) == (1920, 1080, Codec.UYVY, 24.0)
    cap = video_capture.initialize_video_capture("testcard:320:240:30:UYVY", device="cpu")
    assert (cap.desc.width, cap.desc.height, cap.desc.fps) == (320, 240, 30.0)
    with pytest.raises(ValueError, match="unknown codec"):
        video_capture.initialize_video_capture("testcard:c=NOPE", device="cpu")
    with pytest.raises(ValueError, match="unknown capture"):
        video_capture.initialize_video_capture("nosuchdevice", device="cpu")


def test_pace_keeps_the_frame_rate():
    cap = video_capture.initialize_video_capture("testcard:s=64x32:f=100:c=UYVY", device="cpu")
    t0 = time.monotonic()
    for _ in range(6):
        cap.grab()
    elapsed = time.monotonic() - t0
    assert 0.045 <= elapsed < 1.0  # 5 periods of 10 ms after the first grab
    # a late grab does not replay the missed slots
    time.sleep(0.05)
    t1 = time.monotonic()
    cap.grab()
    cap.grab()
    assert time.monotonic() - t1 >= 0.009


def test_testcard2_equals_reference_with_the_same_squares():
    spec = "96:64:1000:UYVY"
    cap = video_capture.Testcard2Capture(spec, device="cpu", rng=np.random.default_rng(5))
    again = video_capture.Testcard2Capture(spec, device="cpu", rng=np.random.default_rng(5))
    assert cap.sq == again.sq
    ref_cap = ref_registry.load_library("testcard2", ref_registry.LibraryClass.VIDEO_CAPTURE)(spec)
    ref_cap.sq = [list(s) for s in cap.sq]  # the reference draws its squares unseeded
    frames = []
    for _ in range(4):
        (f, _a), (rf, _ra) = cap.grab(), ref_cap.grab()
        assert_bytes(f.data, rf.data)
        frames.append(f.data)
    assert not torch.equal(frames[0], frames[1])


# ---- displays ----


def uyvy_frame(w=96, h=64, pattern="bars", ssrc=None):
    data = ref_pattern(w, h, RefCodec.UYVY, pattern)
    rf = RefFrame(RefDesc(w, h, RefCodec.UYVY, 30.0), [jnp.asarray(data)])
    pf = VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [torch.tensor(data)])
    if ssrc is not None:
        rf.callbacks["ssrc"] = pf.callbacks["ssrc"] = ssrc
    return rf, pf


def test_dummy_null_and_codecs():
    d = video_display.initialize_video_display("dummy", device="cpu")
    r = ref_display.initialize_video_display("dummy")
    assert [int(c) for c in d.get_property_codecs()] == [int(c) for c in r.get_property_codecs()]
    forced = video_display.initialize_video_display("dummy:codec=RGB", device="cpu")
    assert forced.get_property_codecs() == [Codec.RGB]
    _, pf = uyvy_frame()
    d.reconfigure(pf.desc)
    d.put_frame(pf)
    d.put_frame(None)
    assert d.frames_shown == 1
    n = video_display.initialize_video_display("null", device="cpu")
    n.put_frame(pf)
    assert n.frames_shown == 0
    with pytest.raises(ValueError, match="unknown display"):
        video_display.initialize_video_display("nosuchdisplay", device="cpu")


def test_get_frame_pool_and_recycle():
    d = video_display.initialize_video_display("dummy", device="cpu")
    with pytest.raises(RuntimeError):
        d.get_frame()
    desc = VideoDesc(64, 32, Codec.UYVY, 30.0)
    d.reconfigure(desc)
    f = d.get_frame()
    assert f.data.shape == (32, 128) and f.data.device.type == "cpu" and not f.data.any()
    f.callbacks["ssrc"] = 7
    d.recycle(f)
    g = d.get_frame()
    assert g is f and g.callbacks == {}
    d.reconfigure(desc.with_(width=32))
    assert d.get_frame() is not f
    # the display's device is the card unless named otherwise
    card = video_display.initialize_video_display("dummy")
    card.reconfigure(desc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            card.get_frame()


def test_dump_and_file_displays_write_the_reference_bytes(tmp_path):
    frames = [uyvy_frame(pattern=p) for p in ("bars", "gradient")]
    for name in ("dump", "file"):
        outs = {}
        for side, mod in (("ref", ref_display), ("port", video_display)):
            path = tmp_path / f"{name}_{side}" if name == "dump" else tmp_path / f"{side}.raw"
            kw = {} if side == "ref" else {"device": "cpu"}
            d = mod.initialize_video_display(f"{name}:{path}", **kw)
            for rf, pf in frames:
                d.put_frame(rf if side == "ref" else pf)
            d.put_frame(None)
            d.done()
            outs[side] = path
        if name == "dump":
            names = sorted(p.name for p in outs["ref"].iterdir())
            assert names == sorted(p.name for p in outs["port"].iterdir()) and len(names) == 2
            for n in names:
                assert (outs["ref"] / n).read_bytes() == (outs["port"] / n).read_bytes()
        else:
            assert outs["ref"].read_bytes() == outs["port"].read_bytes()


@pytest.mark.parametrize("n,size", [(2, "192x128"), (4, "192x128:2"), (3, "160x96")])
def test_conference_composite_equals_reference(n, size):
    r = ref_display.initialize_video_display(f"conference:{size}")
    d = video_display.initialize_video_display(f"conference:{size}", device="cpu")
    for i in range(n):
        rf, pf = uyvy_frame(96, 64, ("bars", "gradient", "noise", "smpte_bars")[i], ssrc=100 + i)
        r.put_frame(rf)
        d.put_frame(pf)
        assert_bytes(d.composite, r.composite)
    assert d.get_property_codecs() == [Codec.UYVY] and len(d.participants) == n


# ---- tiling ----


def test_video_modes():
    for m in tiling.VideoMode:
        rm = ref_tiling.VideoMode[m.name]
        assert m.value == rm.value and (m.x, m.y) == (rm.x, rm.y)
        assert tiling.VideoMode.from_str(m.value[0]) is m
    with pytest.raises(ValueError):
        tiling.VideoMode.from_str("nope")


@pytest.mark.parametrize("codec,grid", [("UYVY", (2, 2)), ("RGB", (3, 1)), ("v210", (1, 2)), ("RGBA", (2, 1))])
def test_split_and_merge_equal_reference(codec, grid):
    w = 288 if codec == "v210" else 192
    data = ref_pattern(w, 64, RefCodec[codec], "smpte_bars")
    rf = RefFrame(RefDesc(w, 64, RefCodec[codec], 30.0), [data])
    pf = VideoFrame(VideoDesc(w, 64, Codec[codec], 30.0), [torch.tensor(data)])
    rf.timestamp = pf.timestamp = 4.0
    rs, ps = ref_tiling.vf_split(rf, *grid), tiling.vf_split(pf, *grid)
    assert desc_tuple(ps.desc) == desc_tuple(rs.desc) and ps.timestamp == 4.0
    for pt, rt in zip(ps.tiles, rs.tiles):
        assert_bytes(pt, rt)
    rm, pm = ref_tiling.vf_merge_tiles(rs, *grid), tiling.vf_merge_tiles(ps, *grid)
    assert desc_tuple(pm.desc) == desc_tuple(rm.desc)
    assert_bytes(pm.data, rm.data)
    assert_bytes(pm.data, data)
    with pytest.raises(ValueError):
        tiling.vf_merge_tiles(ps, 5, 5)
    with pytest.raises(ValueError):
        tiling.vf_split(pf, 7, 1)


# ---- the local loop ----


def collect(register, key):
    got = []
    register(key, got.append)
    return got


@pytest.mark.parametrize("capture_filter,postprocess,codec", [
    ("deinterlace:blend,mirror,border", "scale:96x64", "UYVY"),
    ("every:2,flip", "grayscale", "RGB"),
    ("", "double_framerate:force", "UYVY"),
    ("interlace,deinterlace:linear", "crop:64:32:8:8,gamma:2.2", "RGBA"),
])
def test_run_local_pipeline_equals_reference(capture_filter, postprocess, codec):
    spec = f"testcard:s=192x128:f=1000:c={codec}"
    key = f"loop-{capture_filter}-{postprocess}-{codec}"
    ref_got, got = collect(ref_register_pipe, key), collect(register_pipe_delegate, key)
    n_ref = ref_loop.run_local_pipeline(spec, f"pipe:{key}", 10, capture_filter, postprocess)
    n = loop.run_local_pipeline(spec, f"pipe:{key}", 10, capture_filter, postprocess, device="cpu")
    assert n == n_ref == 10
    assert got[-1] is None and ref_got[-1] is None and len(got) == len(ref_got) > 1
    for f, rf in zip(got[:-1], ref_got[:-1]):
        assert desc_tuple(f.desc) == desc_tuple(rf.desc)
        assert f.data.device.type == "cpu"
        assert_bytes(f.data, rf.data)


def test_pipeline_converts_for_the_display():
    cap = video_capture.initialize_video_capture("testcard:s=96x64:f=1000:c=UYVY", device="cpu")
    disp = video_display.initialize_video_display("dummy:codec=RGB", device="cpu")
    pipe = loop.CaptureToDisplayPipeline(cap, disp, frame_limit=3)
    assert pipe.run() == 3 and disp.frames_shown == 3 and disp.desc.color_spec == Codec.RGB
    assert pipe.queue.maxsize == 2 and pipe.stream is None


def test_pipeline_file_display_equals_reference(tmp_path):
    spec = "testcard:s=128x96:f=1000:c=UYVY"
    ref_loop.run_local_pipeline(spec, f"file:{tmp_path / 'ref.raw'}", 4, "flip", "")
    loop.run_local_pipeline(spec, f"file:{tmp_path / 'port.raw'}", 4, "flip", "", device="cpu")
    data = (tmp_path / "port.raw").read_bytes()
    assert len(data) == 4 * 128 * 96 * 2 and data == (tmp_path / "ref.raw").read_bytes()


def test_pipeline_without_a_display_conversion_stops():
    cap = video_capture.initialize_video_capture("testcard:s=64x32:f=1000:c=v210", device="cpu")
    disp = video_display.initialize_video_display("dummy:codec=DXT1", device="cpu")
    pipe = loop.CaptureToDisplayPipeline(cap, disp, frame_limit=50)
    assert pipe.run() < 50 and disp.frames_shown == 0


def test_pipeline_raises_a_capture_error():
    class Broken(video_capture.VideoCapture):
        def grab(self):
            raise OSError("camera unplugged")

    pipe = loop.CaptureToDisplayPipeline(Broken("", device="cpu"),
                                         video_display.initialize_video_display("dummy", device="cpu"))
    with pytest.raises(OSError, match="unplugged"):
        pipe.run()
    assert not any(t.name == "capture" and t.is_alive() for t in threading.enumerate())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the default device without a card")
    for call in (lambda: video_capture.TestcardCapture("s=64x32"),
                 lambda: video_capture.initialize_video_capture("testcard:s=64x32"),
                 lambda: loop.run_local_pipeline("testcard:s=64x32", "dummy", 1),
                 lambda: generate_pattern(64, 32, Codec.UYVY)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()


# ---- extra displays ----


def test_caca_output_equals_reference(tmp_path):
    rf, pf = uyvy_frame(64, 32)
    texts = []
    for side, mod in (("ref", ref_display), ("port", video_display)):
        out = tmp_path / f"caca_{side}.txt"
        kw = {} if side == "ref" else {"device": "cpu"}
        d = mod.initialize_video_display(f"caca:size=40x12:out={out}", **kw)
        assert d.reconfigure(rf.desc if side == "ref" else pf.desc)
        d.put_frame(rf if side == "ref" else pf)
        d.put_frame(None)
        d.done()
        texts.append(out.read_text())
    assert texts[0] == texts[1] and "▀" in texts[1]


@pytest.mark.parametrize("view", ["size=32x16:fov=90:yaw=0", "size=48x24:fov=60:yaw=270:pitch=20",
                                  "size=40x30:fov=120:yaw=45:pitch=-30"])
def test_pano_view_equals_reference(view):
    from ultragrid_tpu.modules.extra_displays import PanoDisplay as RefPano

    w, h = 128, 64
    data = np.random.default_rng(2).integers(0, 256, (h, w * 3), dtype=np.uint8)
    seen = {}
    r, p = RefPano(view), PanoDisplay(view, device="cpu")
    r.child.put_frame = lambda fr, blocking=True: seen.update(ref=fr)
    p.child.put_frame = lambda fr, blocking=True: seen.update(port=fr)
    r.reconfigure(RefDesc(w, h, RefCodec.RGB, 30.0))
    p.reconfigure(VideoDesc(w, h, Codec.RGB, 30.0))
    r.put_frame(RefFrame(RefDesc(w, h, RefCodec.RGB, 30.0), [jnp.asarray(data)]))
    p.put_frame(VideoFrame(VideoDesc(w, h, Codec.RGB, 30.0), [torch.tensor(data)]))
    assert desc_tuple(seen["port"].desc) == desc_tuple(seen["ref"].desc)
    assert_bytes(seen["port"].data, seen["ref"].data)
    # and from UYVY, through the conversion
    rf, pf = uyvy_frame(128, 64)
    r.reconfigure(rf.desc)
    p.reconfigure(pf.desc)
    p.set_view(yaw=90.0)
    r.set_view(yaw=90.0)
    r.put_frame(rf)
    p.put_frame(pf)
    assert_bytes(seen["port"].data, seen["ref"].data)


def test_pipe_display_delegate_and_poison():
    got = collect(register_pipe_delegate, "t1")
    d = video_display.initialize_video_display("pipe:t1", device="cpu")
    _, pf = uyvy_frame()
    d.reconfigure(pf.desc)
    d.put_frame(pf)
    d.put_frame(None)
    assert len(got) == 2 and got[0] is pf and got[1] is None and d.frames_shown == 1
    with pytest.raises(ValueError):
        video_display.initialize_video_display("pipe:unregistered", device="cpu")


def test_aggregate_display_routes_tiles():
    got = collect(register_pipe_delegate, "agg")
    d = video_display.initialize_video_display("aggregate:dummy#pipe:agg", device="cpu")
    assert d.retains_frames
    desc = VideoDesc(32, 16, Codec.UYVY, 30.0, tile_count=2)
    a, b = (torch.tensor(ref_pattern(32, 16, RefCodec.UYVY, p)) for p in ("bars", "gradient"))
    assert d.reconfigure(desc)
    d.put_frame(VideoFrame(desc, [a, b]))
    assert d.children[0].frames_shown == 1 and got[0].data is b and got[0].desc.tile_count == 1
    d.put_frame(VideoFrame(desc.with_(tile_count=1), [a]))  # one tile: replicated
    assert got[1].data is a
    d.put_frame(None)
    d.done()
    assert got[-1] is None
    ref_codecs = ref_display.initialize_video_display("aggregate:dummy#conference").get_property_codecs()
    codecs = video_display.initialize_video_display("aggregate:dummy#conference", device="cpu").get_property_codecs()
    assert [int(c) for c in codecs] == [int(c) for c in ref_codecs] == [int(Codec.UYVY)]


def test_blend_display_equals_reference():
    from ultragrid_tpu.modules.extra_displays import BlendDisplay as RefBlend

    w, h = 32, 16
    shown = {"ref": [], "port": []}
    r, p = RefBlend("dummy"), BlendDisplay("dummy", device="cpu")
    r.child.put_frame = lambda fr, blocking=True: shown["ref"].append(None if fr is None else np.asarray(fr.data))
    p.child.put_frame = lambda fr, blocking=True: shown["port"].append(None if fr is None else fr.data.numpy())
    r.reconfigure(RefDesc(w, h, RefCodec.RGB, 30.0))
    p.reconfigure(VideoDesc(w, h, Codec.RGB, 30.0))
    rng = np.random.default_rng(4)
    for i, ssrc in enumerate([1, 1, 2] + [2] * 11 + [1, 1]):
        data = rng.integers(0, 256, (h, w * 3), dtype=np.uint8)
        rf = RefFrame(RefDesc(w, h, RefCodec.RGB, 30.0), [data])
        pf = VideoFrame(VideoDesc(w, h, Codec.RGB, 30.0), [torch.tensor(data)])
        rf.callbacks["ssrc"] = pf.callbacks["ssrc"] = ssrc
        r.put_frame(rf)
        p.put_frame(pf)
        assert_bytes(shown["port"][-1], shown["ref"][-1])
    p.put_frame(None)
    assert shown["port"][-1] is None and len(shown["port"]) == 17


# ---- the stitcher ----


@pytest.mark.parametrize("spec", [
    "stitch:testcard:s=64x48:f=1000:c=UYVY#testcard:s=64x48:f=1000:c=RGB:p=gradient;size=128x64;fov=220",
    "stitch:testcard:s=64x48:f=1000:c=RGB:p=noise#testcard:s=64x48:f=1000:c=RGB:p=smpte_bars"
    "#testcard:s=64x48:f=1000:c=UYVY;size=96x48",
    "gpustitch:testcard:s=80x60:f=1000:c=RGB:p=noise;size=64x32;fov=150",
    "stitch:testcard:s=64x48:f=1000:c=RGB:p=noise#testcard:s=64x48:f=1000:c=RGB:p=gradient"
    "#testcard:s=64x48:f=1000:c=RGB#testcard:s=64x48:f=1000:c=RGB:p=uv_plane;size=128x48",
])
def test_stitch_equals_reference(spec):
    ref_cap = ref_capture.initialize_video_capture(spec)
    cap = video_capture.initialize_video_capture(spec, device="cpu")
    assert desc_tuple(cap.desc) == desc_tuple(ref_cap.desc)
    for _ in range(2):
        (f, _a), (rf, _ra) = cap.grab(), ref_cap.grab()
        assert f.data.device.type == "cpu"
        assert_bytes(f.data, rf.data)
    cap.done()
    ref_cap.done()
    with pytest.raises(ValueError, match="at least one"):
        video_capture.initialize_video_capture("stitch:;size=64x32", device="cpu")


# ---- the registry and the capabilities ----


def test_registry_uses_the_reference_names():
    import ultragrid_tpu.audio.midi_synth  # noqa: F401  (the reference's initialize_audio_capture registers it)

    L, RL = registry.LibraryClass, ref_registry.LibraryClass
    assert [c.value for c in L] == [c.value for c in RL]
    assert {c.value: v for c, v in registry.ABI_VERSIONS.items()} == \
        {c.value: v for c, v in ref_registry.ABI_VERSIONS.items()}
    expected = {
        L.VIDEO_COMPRESS: ["apv", "cineform", "cmpto_j2k", "cuda_dxt", "dxt", "gpujpeg", "h264", "j2k", "jpeg",
                           "jpegxs", "lavc", "libavcodec", "none", "openapv", "uyvy"],
        L.VIDEO_DECOMPRESS: ["cineform", "cmpto_j2k", "dxt", "h264_own", "i420", "jpeg", "jpeg_to_dxt", "jpegxs",
                             "libavcodec", "openapv"],
        L.VIDEO_CAPTURE: ["aggregate", "aja", "decklink", "file", "gpustitch", "import", "ndi", "noise", "rtsp",
                          "screen", "stitch", "switcher", "swmix", "testcard", "testcard2", "ug_input", "v4l2"],
        L.VIDEO_DISPLAY: ["aggregate", "blend", "caca", "conference", "decklink", "drm", "dummy", "dump", "file",
                          "gl", "multiplier", "ndi", "null", "openxr_gl", "pano", "pipe", "preview", "sdl", "unix_sock",
                          "unix_socket", "vulkan", "x11", "y4m"],
        L.AUDIO_CAPTURE: ["aes67", "alsa", "coreaudio", "fluidsynth", "jack", "midi", "none", "pipewire",
                          "portaudio", "pulse", "sdi", "testcard", "wasapi", "wav"],
        L.AUDIO_PLAYBACK: ["alsa", "coreaudio", "dummy", "jack", "none", "pipewire", "portaudio", "pulse", "sdi",
                           "wasapi", "wav"],
    }
    for cls, names in expected.items():
        assert registry.list_modules(cls) == names
        assert set(names) <= set(ref_registry.list_modules(RL(cls.value)))
    from ultragrid_tpu_torch.modules.video_compress import JpegCompress
    from ultragrid_tpu_torch.modules.video_decompress import JpegToDxtDecompress

    assert registry.load_library("gpujpeg", L.VIDEO_COMPRESS) is JpegCompress
    assert registry.load_library("jpeg_to_dxt", L.VIDEO_DECOMPRESS) is JpegToDxtDecompress
    assert registry.load_library("nope", L.VIDEO_COMPRESS) is None
    assert registry.load_library("jpeg", L.VIDEO_COMPRESS, abi=1) is None
    # the port's table is its own
    assert ref_registry.load_library("testcard", RL.VIDEO_CAPTURE) is ref_capture.TestcardCapture


def test_capabilities(capsys):
    caps, ref = get_capabilities(), ref_capabilities()
    assert caps["backend"] == "torch-cuda" and ref["backend"] == "jax-tpu"
    assert caps["codecs"] == ref["codecs"] and caps["conversions"] == ref["conversions"]
    for key in ("video_capture", "video_display", "video_compress", "video_decompress",
                "capture_filter", "vo_postprocess"):
        assert set(caps[key]) <= set(ref[key])
    assert caps["capture_filter"] == ref["capture_filter"]
    assert len(caps["devices"]) == torch.cuda.device_count()
    print_capabilities()
    assert json.loads(capsys.readouterr().out) == caps


def test_log_copy_equals_reference(capsys):
    from ultragrid_tpu.utils import log as ref_log
    from ultragrid_tpu_torch.utils import log

    names = [n for n in dir(ref_log) if n.startswith("LOG_LEVEL_")]
    assert names and all(getattr(log, n) == getattr(ref_log, n) for n in names)
    for spec in ("quiet", "fatal", "ERROR", "warning", "notice", "info", "verbose", "debug", "debug2", "7", "nope"):
        assert log.parse_log_level(spec) == ref_log.parse_log_level(spec)
    for mod in (ref_log, log):
        logger = mod.Logger("loop")
        for level in ("fatal", "error", "warning", "notice", "info", "verbose", "debug"):
            getattr(logger, level)(f"{level} message")
        mod.log_msg_once(mod.LOG_LEVEL_ERROR, "once")
        mod.log_msg_once(mod.LOG_LEVEL_ERROR, "once")
    ref_err, port_err = capsys.readouterr().err.split("[loop] fatal message")[1:]
    assert ref_err == port_err and ref_err.count("\n") > 4
