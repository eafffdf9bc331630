"""The port's remaining captures against the JAX package's, on the CPU.

Both packages' modules run on the reference's fakes and their outputs are
held byte-equal: the X11 screen capture on the mock X server of
``tests/test_screen_capture.py`` (imported, not edited) in every case there
-- full screen and viewport, the cursor composite, fps pacing, 16 bpp and
MSB-first pixels, Xauthority, the auth cookie, the registry -- and on the
jax-free copy of that server (``tests/torch_x11_mock.py``) that
``chip_smoke.py`` takes; v4l2's UAPI struct sizes, ioctl numbers,
``PIXFMT_MAP`` and probe message (``tests/test_pipeline.py:350-385``); every
hardware stub's probe message; ``ug_input`` fed by a port sender
(``tests/test_extra_modules.py:112-130``), the grabbed frame equal to the
sent testcard; and ``-s alsa`` still reaching the ALSA module, not its stub.
"""

import ctypes
import glob
import pathlib
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
from ultragrid_tpu.modules import hw_stubs as ref_stubs  # noqa: E402
from ultragrid_tpu.modules import screen_capture as ref_screen  # noqa: E402
from ultragrid_tpu.modules import v4l2_capture as ref_v4l2  # noqa: E402
from ultragrid_tpu.modules.registry import LibraryClass as RefL  # noqa: E402
from ultragrid_tpu.modules.registry import load_library as ref_load  # noqa: E402
from ultragrid_tpu.net import x11 as ref_x11  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401
from ultragrid_tpu_torch.audio.alsa import AlsaAudioCapture, AlsaAudioPlayback  # noqa: E402
from ultragrid_tpu_torch.modules import hw_stubs, screen_capture, ug_input, v4l2_capture  # noqa: E402
from ultragrid_tpu_torch.modules.registry import LibraryClass as L  # noqa: E402
from ultragrid_tpu_torch.modules.registry import load_library  # noqa: E402
from ultragrid_tpu_torch.modules.video_capture import TestcardCapture  # noqa: E402
from ultragrid_tpu_torch.net import x11  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402

from chip_smoke import free_port_pair  # noqa: E402
from tests import torch_x11_mock  # noqa: E402
from tests.test_screen_capture import MockXServer  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def xserver(tmp_path):
    srv = MockXServer(str(tmp_path / "Xmock"))
    yield srv
    srv.close()


def grab_both(cfg):
    """One frame of the reference's capture and one of the port's (on the
    CPU), as [h, w * 3] arrays."""
    ref = ref_screen.ScreenCapture(cfg)
    try:
        want = np.asarray(ref.grab()[0].data)
    finally:
        ref.done()
    cap = screen_capture.ScreenCapture(cfg, device="cpu")
    try:
        frame, _ = cap.grab()
        assert isinstance(frame.data, torch.Tensor) and frame.data.device.type == "cpu"
        got = frame.data.numpy()
        assert frame.desc.color_spec.name == "RGB" and frame.timestamp is not None
    finally:
        cap.done()
    return want, got


def test_connection_and_get_image_equal(xserver):
    for mod in (ref_x11, x11):
        conn = mod.X11Connection(xserver.path)
        assert conn.root == torch_x11_mock.ROOT_WIN and conn.screen["width"] == 64
        assert conn.get_geometry()[2:4] == (64, 32)
        depth, bpp, raw, _ = conn.get_image(0, 0, 64, 32)
        assert (depth, bpp) == (24, 32)
        rgb = screen_capture.zpixmap_to_rgb(raw, 64, 32, bpp, conn.image_byte_order)
        assert np.array_equal(rgb, ref_screen.zpixmap_to_rgb(raw, 64, 32, bpp, conn.image_byte_order))
        assert np.array_equal(rgb.reshape(32, 64, 3), xserver.fb_rgb)
        conn.close()


@pytest.mark.parametrize("cfg,view", [("", (slice(0, 32), slice(0, 64))),
                                      (":geometry=16x8+4+2", (slice(2, 10), slice(4, 20))),
                                      (":size=100x100", (slice(0, 32), slice(0, 64)))])
def test_screen_capture_full_and_viewport(xserver, cfg, view):
    want, got = grab_both(f"display={xserver.path}{cfg}")
    assert want.tobytes() == got.tobytes()
    assert np.array_equal(got.reshape(*xserver.fb_rgb[view].shape), xserver.fb_rgb[view])


@pytest.mark.parametrize("cursor", [
    (10, 5, 2, 2, 0, 0, np.full((2, 2), 0xFFFF0000, np.uint32)),  # the reference test's opaque red
    (62, 30, 5, 4, 1, 1, None),                                  # half outside, translucent
    (-2, -1, 4, 3, 0, 0, None),                                  # above and left of the screen
])
def test_cursor_composite_equal(tmp_path, cursor):
    cx, cy, cw, ch, xh, yh, argb = cursor
    if argb is None:
        rng = np.random.default_rng(cw)
        a = rng.integers(0, 256, (ch, cw)).astype(np.uint32)
        rgb = (rng.integers(0, 256, (ch, cw, 3)) * a[..., None] // 255).astype(np.uint32)
        argb = (a << 24) | (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2]
    srv = MockXServer(str(tmp_path / "Xcur"), with_xfixes=True, cursor=(cx, cy, cw, ch, xh, yh, argb))
    try:
        want, got = grab_both(f"display={srv.path}")
        assert want.tobytes() == got.tobytes()
        assert not np.array_equal(got.reshape(32, 64, 3), srv.fb_rgb)
    finally:
        srv.close()


def test_fps_pacing(xserver):
    cap = screen_capture.ScreenCapture(f"display={xserver.path}:fps=50", device="cpu")
    try:
        cap.grab()
        t0 = time.monotonic()
        for _ in range(5):
            f, _ = cap.grab()
            assert f is not None
        assert time.monotonic() - t0 >= 0.06  # 5 frames at 50 fps; margin for jitter
    finally:
        cap.done()


@pytest.mark.parametrize("bpp,order", [(32, 0), (32, 1), (24, 0), (24, 1), (16, 0), (16, 1)])
def test_zpixmap_conversions_equal(bpp, order):
    w, h = 7, 3
    stride = {32: w * 4, 24: (w * 3 + 3) & ~3, 16: w * 2}[bpp]
    raw = np.random.default_rng(bpp + order).integers(0, 256, stride * h, dtype=np.uint8).tobytes()
    got = screen_capture.zpixmap_to_rgb(raw, w, h, bpp, order)
    assert got.tobytes() == ref_screen.zpixmap_to_rgb(raw, w, h, bpp, order).tobytes()
    # the reference test's fixed cases
    rgb = np.array([[[1, 2, 3], [200, 100, 50]]], np.uint8)
    xrgb = np.zeros((1, 2, 4), np.uint8)
    xrgb[:, :, 1:] = rgb
    assert np.array_equal(screen_capture.zpixmap_to_rgb(xrgb.tobytes(), 2, 1, 32, 1).reshape(1, 2, 3), rgb)
    px = np.array([[0xF800, 0x07E0]], np.uint16).astype("<u2").tobytes()
    assert np.array_equal(screen_capture.zpixmap_to_rgb(px, 2, 1, 16, 0).reshape(1, 2, 3),
                          [[[255, 0, 0], [0, 255, 0]]])
    with pytest.raises(x11.X11Error, match="bpp"):
        screen_capture.zpixmap_to_rgb(raw, w, h, 8, 0)


def test_xauthority_parsing_equal(tmp_path, monkeypatch):
    host = socket.gethostname().encode()

    def rec(family, addr, disp, name, data):
        out = struct.pack(">H", family)
        for f in (addr, disp, name, data):
            out += struct.pack(">H", len(f)) + f
        return out

    auth = tmp_path / "xauth"
    auth.write_bytes(rec(256, host, b"1", b"MIT-MAGIC-COOKIE-1", b"WRONG")
                     + rec(256, host, b"0", b"MIT-MAGIC-COOKIE-1", b"SECRET0")
                     + rec(0, b"elsewhere", b"2", b"MIT-MAGIC-COOKIE-1", b"NOPE"))
    monkeypatch.setenv("XAUTHORITY", str(auth))
    for n in (0, 1, 2, 3):
        assert x11.read_xauthority(n) == ref_x11.read_xauthority(n)
    assert x11.read_xauthority(0) == (b"MIT-MAGIC-COOKIE-1", b"SECRET0")
    for name in (":0", ":1.2", "host:3", "/tmp/sock", "unix:4"):
        assert x11.parse_display(name) == ref_x11.parse_display(name)
    for bad in ("", "host:", "nocolon"):  # the last raises ValueError in both
        errors = []
        for mod in (ref_x11, x11):
            with pytest.raises((x11.X11Error, ref_x11.X11Error, ValueError)) as e:
                mod.parse_display(bad)
            errors.append((type(e.value).__name__, str(e.value)))
        assert errors[0] == errors[1], bad


def test_auth_cookie_sent(tmp_path, monkeypatch):
    auth = tmp_path / "xauth"
    auth.write_bytes(struct.pack(">H", 65535) + b"".join(
        struct.pack(">H", len(f)) + f for f in (b"", b"", b"MIT-MAGIC-COOKIE-1", b"COOKIE99")))
    monkeypatch.setenv("XAUTHORITY", str(auth))
    seen = []
    for mod in (ref_x11, x11):
        srv = MockXServer(str(tmp_path / f"Xauth{len(seen)}"))
        try:
            mod.X11Connection(srv.path).close()
            seen.append(srv.auth_seen)
        finally:
            srv.close()
    assert seen[0] == seen[1] == (b"MIT-MAGIC-COOKIE-1", b"COOKIE99")


def test_the_jax_free_mock_serves_the_same_frames(tmp_path):
    cur = (3, 4, 2, 2, 0, 0, np.full((2, 2), 0x80402010, np.uint32))
    frames = []
    for mod in (torch_x11_mock, sys.modules["tests.test_screen_capture"]):
        srv = mod.MockXServer(str(tmp_path / f"X{len(frames)}"), width=48, height=16, with_xfixes=True, cursor=cur)
        try:
            cap = screen_capture.ScreenCapture(f"display={srv.path}:geometry=40x12+2+1", device="cpu")
            frames.append(cap.grab()[0].data.numpy())
            cap.done()
        finally:
            srv.close()
    assert frames[0].tobytes() == frames[1].tobytes()


def test_screen_capture_registered():
    assert load_library("screen", L.VIDEO_CAPTURE) is screen_capture.ScreenCapture
    assert ref_load("screen", RefL.VIDEO_CAPTURE) is ref_screen.ScreenCapture


def test_v4l2_structs_table_and_probe_equal():
    for name in ("v4l2_capability", "v4l2_pix_format", "v4l2_format", "v4l2_requestbuffers", "v4l2_timecode",
                 "v4l2_buffer", "v4l2_fract", "v4l2_captureparm", "v4l2_streamparm"):
        assert ctypes.sizeof(getattr(v4l2_capture, name)) == ctypes.sizeof(getattr(ref_v4l2, name)), name
    assert ctypes.sizeof(v4l2_capture.v4l2_capability) == 104
    assert ctypes.sizeof(v4l2_capture.v4l2_format) == 208
    assert ctypes.sizeof(v4l2_capture.v4l2_buffer) == 88
    for name in ("VIDIOC_QUERYCAP", "VIDIOC_S_FMT", "VIDIOC_REQBUFS", "VIDIOC_QUERYBUF", "VIDIOC_QBUF",
                 "VIDIOC_DQBUF", "VIDIOC_STREAMON", "VIDIOC_STREAMOFF", "VIDIOC_S_PARM"):
        assert getattr(v4l2_capture, name) == getattr(ref_v4l2, name), name
    assert {c.name: v for c, v in v4l2_capture.PIXFMT_MAP.items()} == \
        {c.name: v for c, v in ref_v4l2.PIXFMT_MAP.items()}
    assert v4l2_capture.PIXFMT_MAP[v4l2_capture.Codec.UYVY] == 0x59565955
    assert load_library("v4l2", L.VIDEO_CAPTURE) is v4l2_capture.V4l2Capture
    assert v4l2_capture.probe_devices() == ref_v4l2.probe_devices()
    if not glob.glob("/dev/video*"):
        msgs = []
        for make in (lambda: ref_v4l2.V4l2Capture(""), lambda: v4l2_capture.V4l2Capture("", device="cpu")):
            with pytest.raises(RuntimeError, match="no /dev/video") as e:
                make()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


VIDEO_STUBS = [(L.VIDEO_CAPTURE, n) for n in ("decklink", "ndi", "aja")] + \
    [(L.VIDEO_DISPLAY, n) for n in ("decklink", "ndi", "sdl", "openxr_gl", "vulkan")]
AUDIO_STUBS = ("pipewire", "jack", "portaudio", "pulse", "coreaudio", "wasapi", "sdi")


@pytest.mark.parametrize("cls,name", VIDEO_STUBS)
def test_video_stub_messages_equal(cls, name):
    msgs = []
    for make in (ref_load(name, RefL(cls.value)), load_library(name, cls)):
        with pytest.raises(RuntimeError, match=name) as e:
            make("")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert load_library(name, cls).__name__ == ref_load(name, RefL(cls.value)).__name__


@pytest.mark.parametrize("name", AUDIO_STUBS)
def test_audio_stub_messages_equal(name):
    for cls in (L.AUDIO_CAPTURE, L.AUDIO_PLAYBACK):
        msgs = []
        for make in (ref_load(name, RefL(cls.value)), load_library(name, cls)):
            with pytest.raises(RuntimeError, match=name) as e:
                make("")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_probe_messages_of_every_name_equal():
    for name in ("decklink", "ndi", "aja", "screen", "sdl", "gl", "openxr_gl", "vulkan", "alsa", "other"):
        assert hw_stubs._probe_msg(name) == ref_stubs._probe_msg(name)
    for name in ("alsa",) + AUDIO_STUBS + ("other",):
        assert hw_stubs._audio_probe_msg(name) == ref_stubs._audio_probe_msg(name)


def test_alsa_reaches_the_alsa_module_not_its_stub():
    assert load_library("alsa", L.AUDIO_CAPTURE) is AlsaAudioCapture
    assert load_library("alsa", L.AUDIO_PLAYBACK) is AlsaAudioPlayback
    # the same when the audio capture module is the first import
    script = ("import ultragrid_tpu_torch.audio.capture as c\n"
              "from ultragrid_tpu_torch.modules.registry import LibraryClass as L, load_library\n"
              "assert load_library('alsa', L.AUDIO_CAPTURE).__name__ == 'AlsaAudioCapture'\n"
              "assert load_library('alsa', L.AUDIO_PLAYBACK).__name__ == 'AlsaAudioPlayback'\n"
              "assert load_library('jack', L.AUDIO_CAPTURE).__name__ == 'JackAudioStub'\n"
              "print('ALSA-OK')\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "ALSA-OK" in res.stdout, res.stderr[-2000:]


@pytest.mark.parametrize("side", ["port", "reference"])
def test_ug_input_takes_a_port_senders_testcard(side):
    """A port sender (``-c none``, still testcard) into ``ug_input`` of the
    port (on the CPU) and of the reference: the grabbed frame is the
    testcard frame sent."""
    port = free_port_pair()
    if side == "port":
        cap = load_library("ug_input", L.VIDEO_CAPTURE)(f"port={port}", device="cpu")
    else:
        cap = ref_load("ug_input", RefL.VIDEO_CAPTURE)(f"port={port}")
    spec = "testcard:s=64x32:f=30:c=UYVY:still=1"
    sent = TestcardCapture(spec.partition(":")[2], device="cpu").grab()[0].data.numpy()
    try:
        sender = VideoSender(spec, "127.0.0.1", compress_spec="none", tx_port=port, frame_limit=8, device="cpu")
        t = threading.Thread(target=sender.run, daemon=True)
        t.start()
        frame, _audio = cap.grab()
        assert frame is not None
        assert frame.desc.width == 64 and frame.desc.height == 32
        data = frame.data.numpy() if isinstance(frame.data, torch.Tensor) else np.asarray(frame.data)
        assert data.tobytes() == sent.tobytes()
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        cap.done()
    if side == "port":
        assert isinstance(cap, ug_input.UgInputCapture) and cap.receiver.device.type == "cpu"


def test_ug_input_drops_when_its_queue_is_full():
    """The delegate the capture hands its receiver's ``pipe`` display keeps
    at most MAX_QUEUE_SIZE frames and drops the rest (ref ug_input.c:58-70);
    the end of the stream always goes in."""
    cap = ug_input.UgInputCapture(f"port={free_port_pair()}", device="cpu")
    try:
        delegate = cap.receiver.display.delegate
        for i in range(5):
            delegate(i)
        assert cap.q.qsize() == ug_input.MAX_QUEUE_SIZE == 2
        delegate(None)
        assert cap.q.qsize() == 3
    finally:
        cap.done()


@pytest.mark.parametrize("side", ["port", "reference"])
def test_first_frame_beyond_the_slot_size_loses_its_first_batch(side):
    """ROADMAP F12, repaired in the port: the receiver's C fast path starts
    with 256 KiB slots.  The reference's hands back the datagrams of the
    receive batch in which a larger frame first arrives and grows its slots
    only then, so that frame shows zeros where those datagrams went (its
    top rows), the frames after it whole.  The port's holds that batch,
    grows the slots and scatters it, so every frame is whole.  At 384x360
    UYVY (270 KiB) with MTU 9000."""
    port = free_port_pair()
    spec = "testcard:s=384x360:f=60:c=UYVY:still=1"
    sent = TestcardCapture(spec.partition(":")[2], device="cpu").grab()[0].data.numpy()
    if side == "port":
        cap = load_library("ug_input", L.VIDEO_CAPTURE)(f"port={port}", device="cpu")
    else:
        cap = ref_load("ug_input", RefL.VIDEO_CAPTURE)(f"port={port}")
    sender = VideoSender(spec, "127.0.0.1", compress_spec="none", tx_port=port, mtu=9000, frame_limit=10,
                         device="cpu")
    t = threading.Thread(target=sender.run, daemon=True)
    t.start()
    try:
        frames = []
        for _ in range(3):
            data = cap.grab()[0].data
            frames.append((data.numpy() if isinstance(data, torch.Tensor) else np.asarray(data)).reshape(sent.shape))
        t.join(timeout=10)
    finally:
        cap.done()
    assert all(np.array_equal(f, sent) for f in frames[1:])
    rows = np.nonzero((frames[0] != sent).any(1))[0]
    if side == "port":
        assert len(rows) == 0
    else:
        assert len(rows) > 0 and rows.tolist() == list(range(len(rows))) and not frames[0][rows].any()
