"""The preview socket of the port against the JAX package's, on the CPU.

``unix_sock`` / ``unix_socket`` / ``preview`` (``modules/ipc_display.py``):
the ipc_frame stream each writes for the same frames (RGB, UYVY and RGBA,
with and without the integer downscale, the first 5 frames skipped) equals
the reference display's, frame by frame; ``thumbnailgen``'s files equal the
reference's (its JAX encoder on the CPU), byte for byte; ``ipc_frame_dump``
prints and saves what the reference's does; the ``preview`` capture filter
tees into a listening reader and passes the frame on.  Frames come from
numpy seeds; sockets live in pytest's temporary directory.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules import ipc_display as ref_ipc  # noqa: E402
from ultragrid_tpu.modules.filters import FilterChain as RefFilterChain  # noqa: E402
from ultragrid_tpu.modules.video_display import initialize_video_display as ref_display  # noqa: E402
from ultragrid_tpu.tools import ipc_frame_dump as ref_dump  # noqa: E402
from ultragrid_tpu.tools import thumbnailgen as ref_thumb  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
from ultragrid_tpu_torch.modules import ipc_display  # noqa: E402
from ultragrid_tpu_torch.modules.filters import FilterChain  # noqa: E402
from ultragrid_tpu_torch.modules.video_display import initialize_video_display  # noqa: E402
from ultragrid_tpu_torch.ops import pixfmt  # noqa: E402
from ultragrid_tpu_torch.tools import ipc_frame_dump, thumbnailgen  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, vc_get_linesize  # noqa: E402


def _frames(w, h, codec, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, vc_get_linesize(w, codec)), dtype=np.uint8) for _ in range(n)]


class _Reader:
    """An IpcFrameReader on a thread, collecting every frame."""

    def __init__(self, cls, path):
        self.reader = cls(path)
        self.got = []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        self.reader.accept(timeout=20)
        while True:
            f = self.reader.read_frame(timeout=20)
            if f is None:
                return
            self.got.append(f)

    def join(self):
        self.thread.join(timeout=20)
        self.reader.close()
        return [(w, h, int(c), d) for w, h, c, d in self.got]


def _stream(package, spec, path, frames, w, h, codec, pause):
    reader = _Reader(ipc_display.IpcFrameReader if package == "port" else ref_ipc.IpcFrameReader, path)
    if package == "port":
        disp = initialize_video_display(f"{spec}:path={path}" if spec else f"unix_sock:path={path}", device="cpu")
        desc = VideoDesc(w, h, codec, 30.0)
        make = lambda f: VideoFrame(desc, [torch.as_tensor(f)])  # noqa: E731
    else:
        disp = ref_display(f"{spec}:path={path}")
        desc = RefDesc(w, h, RefCodec(int(codec)), 30.0)
        make = lambda f: RefFrame(desc, [f])  # noqa: E731
    disp.reconfigure(desc)
    for f in frames:
        disp.put_frame(make(f))
        time.sleep(pause)
    disp.put_frame(None)
    disp.done()
    return reader.join()


_CASES = [
    ("unix_sock", 128, 64, Codec.RGB, "", 0.0),
    ("unix_socket", 256, 128, Codec.UYVY, ":target_size=64x32", 0.0),
    ("unix_sock", 96, 64, Codec.RGBA, ":target_size=48x32", 0.0),
    ("preview", 256, 128, Codec.UYVY, ":target_size=64x32", 0.05),
]


@pytest.mark.parametrize("name,w,h,codec,opts,pause", _CASES, ids=[f"{c[0]}-{c[3].name}" for c in _CASES])
def test_ipc_stream_equals_reference(tmp_path, name, w, h, codec, opts, pause):
    frames = _frames(w, h, codec, 8, seed=w + int(codec))
    got = {pkg: _stream(pkg, name + opts if opts else name, str(tmp_path / f"{pkg}.sock"), frames, w, h, codec,
                        pause)
           for pkg in ("port", "ref")}
    assert got["port"] == got["ref"]
    assert len(got["port"]) == 3  # 8 put, the first 5 skipped
    scale = ipc_display.ipc_scale_factor(w, h, *((int(x) for x in opts.split("=")[1].split("x")) if opts
                                                 else (-1, -1)))
    assert scale == ref_ipc.ipc_scale_factor(w, h, *((int(x) for x in opts.split("=")[1].split("x")) if opts
                                                     else (-1, -1)))
    step = max(scale, 1)
    for (gw, gh, color, data), f in zip(got["port"], frames[5:]):
        rgb = pixfmt.convert_frame(f, w, codec, Codec.RGB, device="cpu") if codec != Codec.RGB else torch.as_tensor(f)
        want = rgb.view(h, w, 3)[::step, ::step].contiguous().numpy().tobytes()
        assert (gw, gh, color) == ((w + step - 1) // step, (h + step - 1) // step, int(Codec.RGB)) and data == want


def test_ipc_header_and_scale_factor_equal_reference():
    assert ipc_display.ipc_frame_write_header(640, 360, 691200, 11) == ref_ipc.ipc_frame_write_header(640, 360,
                                                                                                     691200, 11)
    assert len(ipc_display.ipc_frame_write_header(1, 1, 3, 11)) == 128
    for src, tgt in (((1920, 1080), (960, 540)), ((1920, 1080), (-1, -1)), ((640, 480), (960, 540)),
                     ((3840, 2160), (960, 540)), ((1280, 720), (320, 180))):
        assert ipc_display.ipc_scale_factor(*src, *tgt) == ref_ipc.ipc_scale_factor(*src, *tgt)
    assert ipc_display.ipc_scale_factor(1920, 1080, 960, 540) == 2


def test_unix_sock_refuses_without_a_listener(tmp_path):
    with pytest.raises(OSError):
        initialize_video_display(f"unix_sock:path={tmp_path / 'nobody'}", device="cpu")


@pytest.mark.parametrize("w,h", [(50, 30), (64, 48)], ids=["padded", "aligned"])
def test_thumbnailgen_files_equal_reference(tmp_path, w, h):
    rgb = np.random.default_rng(w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgb = np.clip(rgb.astype(np.int32) // 2 + np.linspace(0, 120, w)[None, :, None].astype(np.int32), 0,
                  255).astype(np.uint8).tobytes()
    thumbnailgen.write_thumbnail(w, h, rgb, str(tmp_path / "port.jpg"), device="cpu")
    ref_thumb.write_thumbnail(w, h, rgb, str(tmp_path / "ref.jpg"))
    port = (tmp_path / "port.jpg").read_bytes()
    assert port[:2] == b"\xff\xd8" and port == (tmp_path / "ref.jpg").read_bytes()


def test_thumbnailgen_main_over_the_preview_socket(tmp_path, capsys):
    path = str(tmp_path / "preview.sock")
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", thumbnailgen.main(
        [path, "-o", str(tmp_path / "out"), "-n", "2", "--device", "cpu"])), daemon=True)
    t.start()
    deadline = time.time() + 10
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.01)
    frames = _frames(96, 64, Codec.UYVY, 8, seed=4)
    disp = initialize_video_display(f"preview:path={path}", device="cpu")
    desc = VideoDesc(96, 64, Codec.UYVY, 30.0)
    disp.reconfigure(desc)
    for f in frames:
        disp.put_frame(VideoFrame(desc, [torch.as_tensor(f)]))
        time.sleep(0.05)
    t.join(timeout=30)
    disp.put_frame(None)
    disp.done()
    assert rc == {"rc": 0}
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == ["thumb_000000.jpg", "thumb_000001.jpg"]
    for name, f in zip(names, frames[5:]):
        rgb = pixfmt.convert_frame(f, 96, Codec.UYVY, Codec.RGB, device="cpu").numpy().tobytes()
        thumbnailgen.write_thumbnail(96, 64, rgb, str(tmp_path / "want.jpg"), device="cpu")
        assert (tmp_path / "out" / name).read_bytes() == (tmp_path / "want.jpg").read_bytes()
    assert capsys.readouterr().out.split() == [str(tmp_path / "out" / n) for n in names]


def test_ipc_frame_dump_equals_reference(tmp_path, capsys):
    frames = _frames(64, 32, Codec.RGB, 7, seed=6)
    out = {}
    for pkg, main, cls in (("port", ipc_frame_dump.main, ipc_display.UnixSockDisplay),
                           ("ref", ref_dump.main, ref_ipc.UnixSockDisplay)):
        path = str(tmp_path / f"{pkg}.sock")
        save = tmp_path / pkg
        save.mkdir()
        t = threading.Thread(target=main, args=([path, "--save", str(save), "-n", "2"],), daemon=True)
        t.start()
        deadline = time.time() + 10
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.01)
        disp = cls(f"path={path}", device="cpu") if pkg == "port" else cls(f"path={path}")
        for f in frames:
            if pkg == "port":
                disp.put_frame(VideoFrame(VideoDesc(64, 32, Codec.RGB, 30.0), [torch.as_tensor(f)]))
            else:
                disp.put_frame(RefFrame(RefDesc(64, 32, RefCodec.RGB, 30.0), [f]))
        t.join(timeout=20)
        disp.done()
        out[pkg] = (capsys.readouterr().out, {p.name: p.read_bytes() for p in sorted(save.iterdir())})
    assert out["port"] == out["ref"]
    assert out["port"][0].splitlines() == ["frame 0: 64x32 RGB 6144 B", "frame 1: 64x32 RGB 6144 B"]
    assert out["port"][1]["frame_000000.ppm"] == b"P6\n64 32\n255\n" + frames[5].tobytes()


def test_preview_filter_tees_into_a_listening_reader(tmp_path):
    w, h = 256, 128
    frames = _frames(w, h, Codec.UYVY, 7, seed=8)
    got = {}
    for pkg in ("port", "ref"):
        path = str(tmp_path / f"{pkg}.sock")
        reader = _Reader(ipc_display.IpcFrameReader if pkg == "port" else ref_ipc.IpcFrameReader, path)
        chain = (FilterChain if pkg == "port" else RefFilterChain)(f"preview:path={path}:target_size=64x32")
        assert chain.filters[0].display is not None
        for f in frames:
            frame = (VideoFrame(VideoDesc(w, h, Codec.UYVY, 30.0), [torch.as_tensor(f)]) if pkg == "port"
                     else RefFrame(RefDesc(w, h, RefCodec.UYVY, 30.0), [f]))
            assert chain.apply(frame) is frame  # the frame passes on, unchanged
            time.sleep(0.05)
        chain.filters[0].done()
        got[pkg] = reader.join()
    assert got["port"] == got["ref"] and len(got["port"]) == 2
    assert got["port"][0][:3] == (64, 32, int(Codec.RGB))
