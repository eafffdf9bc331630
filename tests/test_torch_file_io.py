"""The port's file capture and display modules (``modules/file_io.py``)
against the JAX package's, on the CPU.

The reference's cases from ``tests/test_pipeline.py`` (the Y4M display and
file capture round trip, the multiplier display, the aggregate and switcher
captures, the swmix grid) run in both packages on the same seeded inputs:
Y4M and raw files are byte-equal, and each captured frame equals the
reference's and the file's bytes, on the capture's device.  Tolerance:
exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules.video_capture import initialize_video_capture as ref_capture  # noqa: E402
from ultragrid_tpu.modules.video_display import initialize_video_display as ref_display  # noqa: E402
from ultragrid_tpu.pipeline.loop import run_local_pipeline as ref_run  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch.modules import file_io  # noqa: E402
from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture  # noqa: E402
from ultragrid_tpu_torch.modules.video_display import initialize_video_display  # noqa: E402
from ultragrid_tpu_torch.pipeline.loop import run_local_pipeline  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, vc_get_linesize  # noqa: E402


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def on_cpu(frame):
    return all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in frame.tiles)


def test_y4m_display_and_file_capture_roundtrip(tmp_path):
    """testcard -> y4m in both packages: the files are byte-equal; each
    package's ``file`` capture reads them back as I420, equal frames."""
    spec = "testcard:s=192x128:f=1000:c=UYVY:still=1"
    ours, theirs = str(tmp_path / "port.y4m"), str(tmp_path / "ref.y4m")
    assert run_local_pipeline(spec, f"y4m:{ours}", frame_limit=3, device="cpu") == 3
    assert ref_run(spec, f"y4m:{theirs}", frame_limit=3) == 3
    data = open(ours, "rb").read()
    assert data == open(theirs, "rb").read() and data.startswith(b"YUV4MPEG2 W192 H128 ")
    cap = initialize_video_capture(f"file:{theirs}", device="cpu")
    ref_cap = ref_capture(f"file:{ours}")
    assert cap.desc.color_spec == Codec.I420 and (cap.desc.width, cap.desc.height) == (192, 128)
    assert cap.desc.fps == ref_cap.desc.fps
    for _ in range(3):
        f, _ = cap.grab()
        rf, _ = ref_cap.grab()
        assert on_cpu(f) and f.data.numel() == 192 * 128 * 3 // 2
        assert np.array_equal(host(f.data), host(rf.data))
    assert cap.grab() == (None, None) and ref_cap.grab() == (None, None)
    cap.done()
    ref_cap.done()


def test_y4m_display_of_i420_and_uyvy_frames(tmp_path):
    """The display writes an I420 frame as it is and converts UYVY on the
    frame's device; both files equal the reference's."""
    w, h = 64, 32
    uyvy = np.random.default_rng(1).integers(0, 256, (h, 2 * w), dtype=np.uint8)
    i420 = np.random.default_rng(2).integers(0, 256, w * h * 3 // 2, dtype=np.uint8)
    for codec, data in ((Codec.UYVY, uyvy), (Codec.I420, i420)):
        paths = {}
        for side in ("port", "ref"):
            paths[side] = str(tmp_path / f"{side}-{codec.name}.y4m")
            if side == "port":
                d = initialize_video_display(f"y4m:{paths[side]}", device="cpu")
                desc = VideoDesc(w, h, codec, 25.0)
                frame = VideoFrame(desc, [torch.as_tensor(data)])
            else:
                d = ref_display(f"y4m:{paths[side]}")
                desc = RefDesc(w, h, RefCodec(int(codec)), 25.0)
                frame = RefFrame(desc, [data])
            assert d.reconfigure(desc)
            d.put_frame(frame)
            d.put_frame(frame)
            d.done()
        assert open(paths["port"], "rb").read() == open(paths["ref"], "rb").read()


@pytest.mark.parametrize("codec", [Codec.UYVY, Codec.RGB, Codec.v210])
def test_raw_file_capture_equals_the_file(tmp_path, codec):
    """``file:PATH:WxH:FPS:CODEC``: every frame is the file's bytes, on the
    capture's device, and the reference's frame; ``loop`` starts again at
    the end, and without it the end gives (None, None)."""
    w, h, n = 96, 32, 3
    ls = vc_get_linesize(w, codec)
    frames = np.random.default_rng(4).integers(0, 256, (n, h, ls), dtype=np.uint8)
    path = tmp_path / "raw.bin"
    path.write_bytes(frames.tobytes())
    spec = f"file:{path}:{w}x{h}:1000:{codec.name}"
    cap, ref_cap = initialize_video_capture(spec, device="cpu"), ref_capture(spec)
    assert cap.desc == VideoDesc(w, h, codec, 1000.0)
    for i in range(n):
        f, audio = cap.grab()
        rf, _ = ref_cap.grab()
        assert audio is None and on_cpu(f) and f.data.shape == (h, ls)
        assert np.array_equal(host(f.data), frames[i]) and np.array_equal(host(f.data), host(rf.data))
    assert cap.grab() == (None, None) and ref_cap.grab() == (None, None)
    cap.done()
    ref_cap.done()
    looped = initialize_video_capture(spec + ":loop", device="cpu")
    got = [host(looped.grab()[0].data) for _ in range(n + 1)]
    assert np.array_equal(got[n], frames[0])
    looped.done()


def test_container_file_is_refused_by_name(tmp_path):
    """A file that is neither raw nor Y4M goes to libavformat: one it cannot
    open (a truncated MP4 header) is refused naming it, and so is every
    container where libavcodec is absent."""
    path = tmp_path / "clip.mp4"
    path.write_bytes(b"\x00\x00\x00\x18ftypmp42")
    with pytest.raises(ValueError, match="libavformat"):
        initialize_video_capture(f"file:{path}", device="cpu")


def test_multiplier_display():
    disp = initialize_video_display("multiplier:dummy#null", device="cpu")
    ref = ref_display("multiplier:dummy#null")
    assert len(disp.children) == 2
    assert disp.get_property_codecs() == [Codec(int(c)) for c in ref.get_property_codecs()]
    desc = VideoDesc(64, 48, Codec.UYVY, 30.0)
    assert disp.reconfigure(desc)
    disp.put_frame(disp.get_frame())
    assert disp.children[0].frames_shown == 1 == disp.frames_shown
    disp.done()


def test_aggregate_and_switcher_capture():
    agg_spec = "aggregate:testcard:s=64x48:f=1000:c=UYVY#testcard:s=64x48:f=1000:c=UYVY"
    agg, ref_agg = initialize_video_capture(agg_spec, device="cpu"), ref_capture(agg_spec)
    frame, _ = agg.grab()
    rframe, _ = ref_agg.grab()
    assert frame.desc.tile_count == 2 and len(frame.tiles) == 2 and on_cpu(frame)
    for a, b in zip(frame.tiles, rframe.tiles):
        assert np.array_equal(host(a), host(b))
    agg.done()
    ref_agg.done()

    sw_spec = "switcher:testcard:s=64x48:f=1000:c=UYVY#testcard:s=64x48:f=1000:c=RGB"
    sw, ref_sw = initialize_video_capture(sw_spec, device="cpu"), ref_capture(sw_spec)
    f, _ = sw.grab()
    rf, _ = ref_sw.grab()
    assert f.desc.color_spec == Codec.UYVY and np.array_equal(host(f.data), host(rf.data))
    assert sw.select(1) and ref_sw.select(1) and not sw.select(2)
    f, _ = sw.grab()
    rf, _ = ref_sw.grab()
    assert f.desc.color_spec == Codec.RGB and np.array_equal(host(f.data), host(rf.data))
    sw.done()
    ref_sw.done()


@pytest.mark.parametrize("spec", [
    "swmix:192:64:30:layout=2x1#testcard:s=96x64:c=RGB:pattern=gradient#testcard:s=96x64:c=RGB:pattern=blank",
    "swmix:128:96:30:UYVY#testcard:s=64x48:c=UYVY:pattern=bars#testcard:s=80x60:c=RGB:pattern=gradient"
    "#testcard:s=64x48:c=UYVY:pattern=noise",
])
def test_swmix_capture_grid(spec):
    """swmix composites its inputs on its device: the frame equals the
    reference's (a 2x1 grid of RGB testcards; a default 2x2 grid of mixed
    codecs and sizes, output UYVY)."""
    cap, ref_cap = initialize_video_capture(spec, device="cpu"), ref_capture(spec)
    frame, _ = cap.grab()
    rframe, _ = ref_cap.grab()
    assert on_cpu(frame)
    assert (frame.desc.width, frame.desc.height, int(frame.desc.color_spec)) == \
        (rframe.desc.width, rframe.desc.height, int(rframe.desc.color_spec))
    assert np.array_equal(host(frame.data), host(rframe.data))
    if "layout=2x1" in spec:
        data = host(frame.data)
        assert data[:, : 3 * 96].std() > 5 and data[:, 3 * 96:].max() <= 16
    cap.done()
    ref_cap.done()


def test_file_io_modules_are_registered_in_the_port():
    from ultragrid_tpu_torch.modules.registry import LibraryClass, load_library

    for name, cls in (("file", file_io.RawFileCapture), ("aggregate", file_io.AggregateCapture),
                      ("switcher", file_io.SwitcherCapture), ("swmix", file_io.SwmixCapture)):
        assert load_library(name, LibraryClass.VIDEO_CAPTURE) is cls
    for name, cls in (("y4m", file_io.Y4mDisplay), ("multiplier", file_io.MultiplierDisplay)):
        assert load_library(name, LibraryClass.VIDEO_DISPLAY) is cls
