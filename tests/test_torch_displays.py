"""The port's windowed displays against the JAX package's, on the CPU.

Every case of ``tests/test_gl_display.py``, ``tests/test_x11_display.py``
and ``tests/test_drm_display.py``, run across the two packages: the same
seeded frames (host arrays for the reference, CPU tensors for the port)
through the reference's display and the port's.  Both use the same Mesa
(gl), the same wire protocol against the same mock X server (x11) and the
same fake KMS device (drm), so the tolerance is none: rendered images,
window contents, scanout buffers and CRTC histories are equal byte for
byte.  The reference tests' own checks (against the device conversions and
the DXT decoders) are kept on the port's side.  Then the card path of
``chip_smoke.py``'s phase ``remaining`` row (a) at a small size: a JPEG +
LDGM session with one data packet lost a frame into ``-d x11`` and ``-d gl``,
every shown image equal to the reference's rendering of the reference's
decode of the same file.
"""

import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference on the CPU)

import ultragrid_tpu.modules  # noqa: E402,F401  (registers the reference's modules)
import ultragrid_tpu.modules.drm_display as ref_drm  # noqa: E402
from ultragrid_tpu.modules.gl_display import GlDisplay as RefGlDisplay  # noqa: E402
from ultragrid_tpu.modules.x11_display import X11Display as RefX11Display  # noqa: E402
from ultragrid_tpu.modules.x11_display import rgb_to_zpixmap as ref_zpixmap  # noqa: E402
from ultragrid_tpu.ops import color as ref_color  # noqa: E402
from ultragrid_tpu.ops import dxt as ref_dxt  # noqa: E402
from ultragrid_tpu.ops import jpeg as ref_jpeg  # noqa: E402
from ultragrid_tpu.ops.jpeg import decode_jpeg_to_frame as ref_decode_jpeg  # noqa: E402
from ultragrid_tpu.types import Codec as RefCodec  # noqa: E402
from ultragrid_tpu.types import VideoDesc as RefDesc  # noqa: E402
from ultragrid_tpu.types import VideoFrame as RefFrame  # noqa: E402
from ultragrid_tpu.utils import params as ref_params  # noqa: E402

import ultragrid_tpu_torch.modules  # noqa: E402,F401  (registers the port's modules)
import ultragrid_tpu_torch.modules.drm_display as drm  # noqa: E402
from ultragrid_tpu_torch.modules.gl_display import GlDisplay  # noqa: E402
from ultragrid_tpu_torch.modules.registry import LibraryClass, load_library  # noqa: E402
from ultragrid_tpu_torch.modules.x11_display import X11Display, rgb_to_zpixmap  # noqa: E402
from ultragrid_tpu_torch.ops import color, dxt, pixfmt  # noqa: E402
from ultragrid_tpu_torch.ops.convs_yuv import uyvy_to_rgb  # noqa: E402
from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver  # noqa: E402
from ultragrid_tpu_torch.pipeline.sender import VideoSender  # noqa: E402
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame  # noqa: E402
from ultragrid_tpu_torch.utils import params  # noqa: E402
from ultragrid_tpu_torch.utils.glctx import GLContext, GLError  # noqa: E402
from ultragrid_tpu_torch.utils.pattern import generate_pattern  # noqa: E402

from chip_smoke import drop_data_packets, free_port_pair  # noqa: E402
from tests import test_screen_capture as ref_mock  # noqa: E402
from tests import torch_x11_mock  # noqa: E402
from tests.test_drm_display import FakeKms  # noqa: E402


def _pattern(w, h, codec, name):
    return generate_pattern(w, h, codec, name, device="cpu").numpy()


@pytest.fixture(autouse=True)
def _clean_params():
    yield
    params.reset_params()
    ref_params.reset_params()


# ---------------------------------------------------------------------------
# gl
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gl_caps():
    """Whether this machine makes an EGL surfaceless context, and its S3TC."""
    try:
        ctx = GLContext()
    except GLError as e:
        pytest.skip(f"no EGL surfaceless GL context: {e}")
    s3tc = ctx.has_s3tc
    ctx.destroy()
    return s3tc


def _both_render(codec, w, h, data, cfg=""):
    """The rendered [h, w, 3] images of one frame through each package's
    gl display: (port, reference)."""
    out = []
    for cls, mk in ((GlDisplay, lambda: VideoFrame(VideoDesc(w, h, codec, 30.0), [torch.as_tensor(data)])),
                    (RefGlDisplay, lambda: RefFrame(RefDesc(w, h, RefCodec(int(codec)), 30.0), [data]))):
        disp = cls(cfg, device="cpu") if cls is GlDisplay else cls(cfg)
        try:
            assert int(codec) in [int(c) for c in disp.get_property_codecs()]
            desc = VideoDesc(w, h, codec, 30.0) if cls is GlDisplay else RefDesc(w, h, RefCodec(int(codec)), 30.0)
            assert disp.reconfigure(desc)
            disp.put_frame(mk())
            img = disp.last_rgb()
            assert img is not None and img.shape == (h, w, 3)
            out.append(img.copy())
        finally:
            disp.done()
    assert np.array_equal(out[0], out[1])
    return out[0]


def _dxt_case(kind):
    rng = np.random.default_rng({"dxt1": 2, "dxt5": 3}.get(kind, 0))
    if kind == "dxt1":
        w, h = 32, 16
        base = np.linspace(0, 255, w, dtype=np.float32)
        rgb = np.stack([base + rng.normal(0, 4, w) for _ in range(3 * h)]).clip(0, 255).astype(np.uint8)
        rgb = rgb.reshape(h, 3 * w)
        return w, h, Codec.DXT1, dxt.dxt1_encode_rgb(torch.as_tensor(rgb), w).numpy(), rgb
    if kind == "dxt5":
        w, h = 32, 16
        rgb = rng.integers(0, 256, (h, 3 * w), dtype=np.uint8)
        return w, h, Codec.DXT5, dxt.dxt5_ycocg_encode_rgb(torch.as_tensor(rgb), w).numpy(), rgb
    w, h = 64, 32
    uyvy = _pattern(w, h, Codec.UYVY, "bars")
    return w, h, Codec.DXT1_YUV, dxt.dxt1_yuv_encode_uyvy(torch.as_tensor(uyvy), w).numpy(), uyvy


def test_gl_rgb_and_rgba_passthrough_exact(gl_caps):
    w, h = 48, 24
    rgb = _pattern(w, h, Codec.RGB, "bars").reshape(h, w, 3)
    assert np.array_equal(_both_render(Codec.RGB, w, h, rgb.reshape(h, -1)), rgb)
    rgba = np.random.default_rng(7).integers(0, 256, (16, 32, 4), dtype=np.uint8)
    assert np.array_equal(_both_render(Codec.RGBA, 32, 16, rgba.reshape(16, -1)), rgba[:, :, :3])


@pytest.mark.parametrize("cs", ["709-bars", "601-random"])
def test_gl_uyvy_shader_equals_reference(gl_caps, cs):
    """The UYVY shader's coefficients follow the port's default colour space
    (ops/color.py), as the reference's follow its own; both renders equal,
    and within 2 of the port's device conversion (the reference's gate)."""
    if cs == "709-bars":
        w, h = 64, 32
        uyvy = _pattern(w, h, Codec.UYVY, "bars")
    else:
        w, h = 32, 18
        uyvy = np.random.default_rng(1).integers(16, 236, (h, 2 * w), dtype=np.uint8)
        color.set_default_cs(color.Colorspace.CS_601)
        ref_color.set_default_cs(ref_color.Colorspace.CS_601)
    try:
        out = _both_render(Codec.UYVY, w, h, uyvy)
        want = uyvy_to_rgb(torch.as_tensor(uyvy), w).numpy().reshape(h, w, 3)
    finally:
        color.set_default_cs(color.Colorspace.CS_709)
        ref_color.set_default_cs(ref_color.Colorspace.CS_709)
    assert np.max(np.abs(out.astype(int) - want.astype(int))) <= 2


@pytest.mark.parametrize("kind", ["dxt1", "dxt5", "dxt1_yuv"])
def test_gl_s3tc_driver_decode_equals_reference(gl_caps, kind):
    """Driver S3TC decode (and the YCoCg / YUV shaders) on the port's DXT
    streams, which equal the reference encoders'; each render equal to the
    reference's and within the reference tests' bounds of the own decoders."""
    if not gl_caps:
        pytest.skip("driver lacks S3TC")
    w, h, codec, comp, src = _dxt_case(kind)
    ref_enc = {"dxt1": lambda: ref_dxt.dxt1_encode_rgb(src, w), "dxt5": lambda: ref_dxt.dxt5_ycocg_encode_rgb(src, w),
               "dxt1_yuv": lambda: ref_dxt.dxt1_yuv_encode_uyvy(src, w)}[kind]
    assert np.array_equal(comp, np.asarray(ref_enc()))
    out = _both_render(codec, w, h, comp)
    if kind == "dxt1":
        want = dxt.dxt1_decode_rgb(torch.as_tensor(comp), w, h).numpy().reshape(h, w, 3)
        assert np.max(np.abs(out.astype(int) - want.astype(int))) <= 4
    elif kind == "dxt5":
        want = dxt.dxt5_ycocg_decode_rgb(torch.as_tensor(comp), w, h).numpy().reshape(h, w, 3)
        assert np.max(np.abs(out.astype(int) - want.astype(int))) <= 6
    else:
        want = uyvy_to_rgb(torch.as_tensor(src), w).numpy().reshape(h, w, 3)
        assert np.median(np.abs(out.astype(int) - want.astype(int))) <= 4


def test_gl_deinterlace_pass(gl_caps):
    w, h = 16, 8
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[0::2] = 200
    out = _both_render(Codec.RGB, w, h, rgb.reshape(h, -1), cfg="deinterlace")
    want = (rgb[:, :, 0].astype(np.float32) + rgb[np.minimum(np.arange(h) + 1, h - 1), :, 0]) / 2.0
    assert np.max(np.abs(out[:, :, 0].astype(np.float32) - want)) <= 1.0
    assert np.all(out[0] == out[1])


def test_gl_windowed_presentation(gl_caps, tmp_path):
    """gl:window blits the rendered RGB through each package's X11 client:
    the two mock servers' windows hold the same image under the same title."""
    w, h = 48, 24
    rgb = _pattern(w, h, Codec.RGB, "bars").reshape(h, w, 3)
    windows = []
    for name, cls, mock, mk in (
            ("port", GlDisplay, torch_x11_mock,
             lambda: VideoFrame(VideoDesc(w, h, Codec.RGB, 30.0), [torch.as_tensor(rgb.reshape(h, -1))])),
            ("ref", RefGlDisplay, ref_mock, lambda: RefFrame(RefDesc(w, h, RefCodec.RGB, 30.0), [rgb.reshape(h, -1)]))):
        srv = mock.MockXServer(str(tmp_path / f"X{name}"))
        try:
            cfg = f"display={srv.path}:title=gltest"
            disp = cls(cfg, device="cpu") if name == "port" else cls(cfg)
            desc = VideoDesc(w, h, Codec.RGB, 30.0) if name == "port" else RefDesc(w, h, RefCodec.RGB, 30.0)
            assert disp.reconfigure(desc)
            disp.put_frame(mk())
            wid = next(iter(srv.mapped))
            assert srv.titles.get(wid) == "gltest"
            windows.append(srv.windows[wid].copy())
            disp.done()
            assert wid not in srv.windows
        finally:
            srv.close()
    assert np.array_equal(windows[0], windows[1]) and np.array_equal(windows[0], rgb)


def test_gl_dxt1_rtp_native_display_passthrough(gl_caps):
    """DXT1 over RTP lands in the port's gl display as a compressed texture,
    no decompression stage; the rendered image equals the reference's
    rendering of the same DXT1 frame."""
    if not gl_caps:
        pytest.skip("driver lacks S3TC")
    port = free_port_pair()
    recv = VideoReceiver("gl", rx_port=port, frame_limit=2, timeout=60.0, device="cpu")
    shown = []
    put = recv.display.put_frame

    def keep(frame, blocking=True):
        if frame is not None:
            shown.append(np.array(frame.data))
        put(frame, blocking)

    recv.display.put_frame = keep
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    VideoSender("testcard:64:48:30:UYVY", "127.0.0.1", compress_spec="dxt", tx_port=port, frame_limit=4,
                device="cpu").run()
    t.join(timeout=60)
    assert recv.frames_displayed >= 1 and shown
    assert recv._decompress is None
    assert recv.display.desc.color_spec == Codec.DXT1
    got = recv.display.last_rgb().copy()
    recv.display.done()
    ref = RefGlDisplay("")
    try:
        ref.reconfigure(RefDesc(64, 48, RefCodec.DXT1, 30.0))
        ref.put_frame(RefFrame(RefDesc(64, 48, RefCodec.DXT1, 30.0), [shown[-1]]))
        assert np.array_equal(got, ref.last_rgb())
    finally:
        ref.done()


def test_gl_pipeline_e2e_testcard(gl_caps):
    cls = load_library("gl", LibraryClass.VIDEO_DISPLAY)
    assert cls is GlDisplay
    uyvy = _pattern(64, 32, Codec.UYVY, "smpte_bars")
    disp = cls("", device="cpu")
    try:
        assert disp.reconfigure(VideoDesc(64, 32, Codec.UYVY, 30.0))
        for _ in range(3):
            disp.put_frame(VideoFrame(VideoDesc(64, 32, Codec.UYVY, 30.0), [torch.as_tensor(uyvy)]))
        assert disp.frames_shown == 3
        got = disp.last_rgb().copy()
    finally:
        disp.done()
    assert np.array_equal(got, _both_render(Codec.UYVY, 64, 32, uyvy))


# ---------------------------------------------------------------------------
# x11
# ---------------------------------------------------------------------------


def _x11_both(tmp_path, cfg, script):
    """Run ``script(display, server, package)`` against each package's x11
    display and mock server; returns the two results."""
    out = []
    for name, cls, mock in (("port", X11Display, torch_x11_mock), ("ref", RefX11Display, ref_mock)):
        srv = mock.MockXServer(str(tmp_path / f"X{name}"))
        try:
            c = cfg.format(path=srv.path)
            disp = cls(c, device="cpu") if name == "port" else cls(c)
            out.append(script(disp, srv, name))
        finally:
            srv.close()
    return out


def _frame(pkg, w, h, codec, data):
    if pkg == "port":
        return VideoFrame(VideoDesc(w, h, codec, 30.0), [torch.as_tensor(data)])
    return RefFrame(RefDesc(w, h, RefCodec(int(codec)), 30.0), [data])


def _desc(pkg, w, h, codec):
    return VideoDesc(w, h, codec, 30.0) if pkg == "port" else RefDesc(w, h, RefCodec(int(codec)), 30.0)


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while not cond() and time.monotonic() - t0 < timeout:
        time.sleep(0.01)
    assert cond()


def test_x11_window_lifecycle_and_contents(tmp_path):
    w, h = 48, 24
    rgb = _pattern(w, h, Codec.RGB, "bars").reshape(h, w, 3)

    def script(disp, srv, pkg):
        assert disp.reconfigure(_desc(pkg, w, h, Codec.RGB))
        _wait(lambda: srv.mapped)
        wid = next(iter(srv.mapped))
        disp.put_frame(_frame(pkg, w, h, Codec.RGB, rgb.reshape(h, -1)))
        got = (srv.titles.get(wid), srv.windows[wid].copy())
        disp.done()
        _wait(lambda: wid not in srv.windows)
        return got

    port, ref = _x11_both(tmp_path, "display={path}:title=ugtest", script)
    assert port[0] == ref[0] == "ugtest"
    assert np.array_equal(port[1], ref[1]) and np.array_equal(port[1], rgb)


def test_x11_window_title_from_the_cli(tmp_path):
    """``--window-title`` (the ``window-title`` param) names the window
    where the config gives no title, in both packages."""
    params.set_commandline_param("window-title", "from-cli")
    ref_params.set_commandline_param("window-title", "from-cli")

    def script(disp, srv, pkg):
        assert disp.reconfigure(_desc(pkg, 16, 8, Codec.RGB))
        wid = next(iter(srv.mapped))
        disp.done()
        return srv.titles.get(wid)

    assert _x11_both(tmp_path, "display={path}", script) == ["from-cli", "from-cli"]


def test_x11_rgba_and_reconfigure_resize(tmp_path):
    rgba = np.random.default_rng(3).integers(0, 256, (16, 32, 4), dtype=np.uint8)

    def script(disp, srv, pkg):
        assert disp.reconfigure(_desc(pkg, 32, 16, Codec.RGBA))
        disp.put_frame(_frame(pkg, 32, 16, Codec.RGBA, rgba.reshape(16, -1)))
        wid = next(iter(srv.mapped))
        got = srv.windows[wid].copy()
        assert disp.reconfigure(_desc(pkg, 40, 20, Codec.RGB))
        _wait(lambda: wid not in srv.windows and len(srv.windows) == 1)
        disp.done()
        return got

    port, ref = _x11_both(tmp_path, "display={path}", script)
    assert np.array_equal(port, ref) and np.array_equal(port, rgba[:, :, :3])


def test_x11_putimage_row_chunking(tmp_path):
    rgb = _pattern(64, 32, Codec.RGB, "gradient").reshape(32, 64, 3)

    def script(disp, srv, pkg):
        assert disp.reconfigure(_desc(pkg, 64, 32, Codec.RGB))
        disp.conn.max_req_bytes = 64 * 4 * 8 + 24  # force ~4 chunks
        before = srv.put_count
        disp.put_frame(_frame(pkg, 64, 32, Codec.RGB, rgb.reshape(32, -1)))
        wid = next(iter(srv.mapped))
        got = (srv.put_count - before, srv.windows[wid].copy())
        disp.done()
        return got

    port, ref = _x11_both(tmp_path, "display={path}", script)
    assert port[0] == ref[0] == 4
    assert np.array_equal(port[1], ref[1]) and np.array_equal(port[1], rgb)


def test_x11_zpixmap_byte_orders():
    rgb = np.random.default_rng(5).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    for order in (0, 1):
        assert rgb_to_zpixmap(torch.as_tensor(rgb), order) == ref_zpixmap(rgb, order)
    lsb = np.frombuffer(rgb_to_zpixmap(torch.arange(12, dtype=torch.uint8).reshape(2, 2, 3), 0), np.uint8)
    assert (lsb.reshape(2, 2, 4)[0, 0, :3] == [2, 1, 0]).all()  # B,G,R


def test_x11_pipeline_e2e_testcard(tmp_path, monkeypatch):
    """testcard UYVY -> the device conversion to RGB -> the x11 window, as
    ``-d x11`` is loaded from the registry."""
    monkeypatch.setenv("DISPLAY", str(tmp_path / "Xport"))
    assert load_library("x11", LibraryClass.VIDEO_DISPLAY) is X11Display
    uyvy = _pattern(64, 32, Codec.UYVY, "bars")

    def script(disp, srv, pkg):
        assert disp.reconfigure(_desc(pkg, 64, 32, Codec.RGB))
        if pkg == "port":
            rgb = pixfmt.convert_frame(torch.as_tensor(uyvy), 64, Codec.UYVY, Codec.RGB, device="cpu")
        else:
            from ultragrid_tpu.ops import pixfmt as ref_pixfmt

            rgb = np.asarray(ref_pixfmt.convert_frame(uyvy, 64, RefCodec.UYVY, RefCodec.RGB), np.uint8)
        disp.put_frame(_frame(pkg, 64, 32, Codec.RGB, rgb))
        wid = next(iter(srv.mapped))
        got = srv.windows[wid].copy()
        disp.done()
        return got

    port, ref = _x11_both(tmp_path, "display={path}", script)
    assert np.array_equal(port, ref)


# ---------------------------------------------------------------------------
# drm
# ---------------------------------------------------------------------------


def _kms(monkeypatch, mod, uyvy_ok=True):
    kms = FakeKms(uyvy_ok=uyvy_ok)
    monkeypatch.setattr(mod, "_ioctl", kms.ioctl)
    monkeypatch.setattr(mod, "_open", kms.open)
    monkeypatch.setattr(mod, "probe_devices", lambda: ["/dev/dri/card0"])
    return kms


def _drm_both(monkeypatch, script, uyvy_ok=True):
    out = []
    for pkg, mod in (("port", drm), ("ref", ref_drm)):
        kms = _kms(monkeypatch, mod, uyvy_ok)
        try:
            out.append(script(mod, kms, pkg))
        finally:
            try:  # done() already closed its fd (== the memfd)
                os.close(kms.memfd)
            except OSError:
                pass
    return out


def _rgb_data(w, h, r, g, b):
    data = np.zeros((h, 3 * w), np.uint8)
    px = data.reshape(h, w, 3)
    px[:, :, 0], px[:, :, 1], px[:, :, 2] = r, g, b
    return data


def _make_drm(mod, pkg, cfg=""):
    return mod.DrmDisplay(cfg, device="cpu") if pkg == "port" else mod.DrmDisplay(cfg)


def test_drm_modeset_and_swap(monkeypatch):
    def script(mod, kms, pkg):
        d = _make_drm(mod, pkg)
        assert (d.mode.hdisplay, d.mode.vdisplay) == (1024, 768) and d.uyvy_ok
        d.reconfigure(_desc(pkg, 640, 480, Codec.RGB))
        first = kms.crtc_log[-1]
        d.put_frame(_frame(pkg, 640, 480, Codec.RGB, _rgb_data(640, 480, 10, 20, 30)))
        scan1 = d.front.view.copy()
        d.put_frame(_frame(pkg, 640, 480, Codec.RGB, _rgb_data(640, 480, 1, 2, 3)))
        scan2 = d.front.view.copy()
        assert kms.crtc_log[-1] == first  # swapped back
        d.done()
        assert kms.current_fb == 7  # the original scanout restored
        return scan1, scan2, list(kms.crtc_log), sorted(kms.destroyed_handles)

    port, ref = _drm_both(monkeypatch, script)
    for a, b in zip(port, ref):
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
    y0, xb = (768 - 480) // 2, ((1024 * 4 - 640 * 4) // 2) & ~3
    assert list(port[0][y0, xb:xb + 4]) == [30, 20, 10, 0] and not port[0][0, :16].any()


def test_drm_requested_mode_and_uyvy_fb(monkeypatch):
    data = np.arange(240 * 640, dtype=np.uint8).reshape(240, 640)

    def script(mod, kms, pkg):
        d = _make_drm(mod, pkg, "dev=/dev/dri/card0:connector=HDMI-A-1:mode=640x480@30")
        assert (d.mode.hdisplay, d.mode.vdisplay, d.mode.vrefresh) == (640, 480, 30)
        d.reconfigure(_desc(pkg, 320, 240, Codec.UYVY))
        fourcc = kms.fbs[kms.crtc_log[-1]][1]
        d.put_frame(_frame(pkg, 320, 240, Codec.UYVY, data))
        scan = d.front.view.copy()
        d.done()
        return fourcc, scan

    port, ref = _drm_both(monkeypatch, script)
    assert port[0] == ref[0] == drm.DRM_FORMAT_UYVY and np.array_equal(port[1], ref[1])
    y0, xb = (480 - 240) // 2, ((640 * 2 - 320 * 2) // 2) & ~3
    assert np.array_equal(port[1][y0, xb:xb + 640], data[0])


def test_drm_unsupported_uyvy_probe(monkeypatch):
    def script(mod, kms, pkg):
        d = _make_drm(mod, pkg)
        assert not d.uyvy_ok and int(Codec.UYVY) not in [int(c) for c in d.get_property_codecs()]
        d.reconfigure(_desc(pkg, 64, 48, Codec.RGB))
        d.put_frame(_frame(pkg, 64, 48, Codec.RGB, _rgb_data(64, 48, 9, 8, 7)))
        scan = d.front.view.copy()
        d.done()
        return scan

    port, ref = _drm_both(monkeypatch, script, uyvy_ok=False)
    assert np.array_equal(port, ref)


def test_drm_probe_failure_message(monkeypatch):
    for mod, make in ((drm, lambda: drm.DrmDisplay("", device="cpu")), (ref_drm, lambda: ref_drm.DrmDisplay(""))):
        monkeypatch.setattr(mod, "probe_devices", lambda: [])
        with pytest.raises(RuntimeError, match="no /dev/dri"):
            make()
    assert load_library("drm", LibraryClass.VIDEO_DISPLAY) is drm.DrmDisplay


# ---------------------------------------------------------------------------
# the card path of phase "remaining" row (a), at a small size on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("display", ["x11", "gl"])
def test_jpeg_ldgm_session_with_loss_into_a_windowed_display(display, tmp_path, request, monkeypatch):
    """sender -> 127.0.0.1 -> receiver, JPEG q80 + LDGM with one seeded data
    packet dropped a frame (the peel on tensors), into ``-d x11`` against the
    mock server or ``-d gl``: every shown image equals the reference's x11 /
    gl rendering of the reference's decode of the file sent for that
    frame.  The reference's module-level decoder caches its planes product
    under table ids, not values (ROADMAP F3), so a stream of another quality
    decoded earlier in the process would change its decode: it gets a fresh
    one here."""
    monkeypatch.setattr(ref_jpeg, "_DEVICE_DECODER", None)
    if display == "gl":
        request.getfixturevalue("gl_caps")
    w, h, n, k, m = 128, 64, 4, 32, 16
    srv = torch_x11_mock.MockXServer(str(tmp_path / "Xrow"))
    files, shown = {}, []
    try:
        params.set_commandline_param("ldgm-device", "device")
        port = free_port_pair()
        spec = f"x11:display={srv.path}" if display == "x11" else "gl"
        recv = VideoReceiver(spec, rx_port=port, frame_limit=n, timeout=20.0, device="cpu")
        put = recv.display.put_frame

        def keep(frame, blocking=True):
            put(frame, blocking)
            if frame is None:
                return
            if display == "x11":
                shown.append((frame.timestamp, next(iter(srv.windows.values())).copy()))
            else:
                shown.append((frame.timestamp, recv.display.last_rgb().copy()))

        recv.display.put_frame = keep
        t = threading.Thread(target=recv.run, daemon=True)
        t.start()
        time.sleep(0.2)
        sender = VideoSender(f"testcard:s={w}x{h}:f=60:c=UYVY", "127.0.0.1", compress_spec="jpeg:80",
                             fec_spec=f"ldgm:{k}:{m}:5", tx_port=port, mtu=400, frame_limit=n + 6, device="cpu")
        send_video = sender.tx.send_video

        def tap(session, frame, *args, **kwargs):
            files[len(files)] = bytes(np.asarray(frame.data).reshape(-1))
            return send_video(session, frame, *args, **kwargs)

        sender.tx.send_video = tap
        dropped = drop_data_packets(sender.session, 1, 11, k, m)
        sender.run()
        t.join(timeout=20)
        assert not t.is_alive()
        recv.display.done()
    finally:
        srv.close()
    assert len(shown) >= n and sum(dropped) >= n and recv.rx_state.fec_recovered >= n
    # the codec the receiver negotiated with the display (x11: RGB; gl: UYVY,
    # converted by the shader)
    codec = RefCodec(int(recv.display.desc.color_spec))
    sent = {}
    ref_srv = ref_mock.MockXServer(str(tmp_path / "Xref"))
    try:
        ref = RefX11Display(f"display={ref_srv.path}") if display == "x11" else RefGlDisplay("")
        ref.reconfigure(RefDesc(w, h, codec, 60.0))
        for f in files.values():
            frame = ref_decode_jpeg(RefFrame(RefDesc(w, h, RefCodec.JPEG, 60.0), [np.frombuffer(f, np.uint8)]),
                                    codec)
            ref.put_frame(frame)
            img = next(iter(ref_srv.windows.values())) if display == "x11" else ref.last_rgb()
            sent[img.tobytes()] = True
        ref.done()
    finally:
        ref_srv.close()
    for _, img in shown:
        assert img.tobytes() in sent
