"""DRM/KMS direct display (``-d drm``) — no X11/Wayland needed.

Parity with the reference's drm display (ref: src/video_display/drm.cpp):
open a DRI card, pick a connected connector (or the one named by
``connector=``), use its preferred mode (or ``mode=WxH[@rate]``), drive the
CRTC with double-buffered dumb framebuffers, center each frame into the
back buffer with pitch math (ref drm.cpp:768-800 draw_frame), swap on putf
(ref drm.cpp:914-918 swap_buffers), and restore the original CRTC on exit
(ref drm.cpp:886-896 display_drm_done).

Implemented pure-ctypes against the kernel DRM UAPI (drm_mode.h ioctls) —
no libdrm dependency, same spirit as the v4l2 capture module.  Without a
/dev/dri device init fails with a clear probe message (the reference
behaves the same).

Config: ``drm[:dev=/dev/dri/card0][:connector=<name>][:mode=WxH[@rate]]``.

The port of ``ultragrid_tpu/modules/drm_display.py``: a frame is laid out in
the framebuffer's pixel format (XRGB8888 or UYVY) on its own device and comes
to the host once, through the displays' download helper, to be copied into
the mapped dumb buffer.
"""

from __future__ import annotations

import ctypes
import glob
import mmap
import os
from fcntl import ioctl as _fcntl_ioctl
from typing import List, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_display import VideoDisplay, _host_bytes
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("drm")

# test seams (the fake KMS device in tests swaps these)
_ioctl = _fcntl_ioctl
_open = os.open


# ---------------------------------------------------------------------------
# DRM UAPI structs (drm_mode.h) — stable kernel ABI
# ---------------------------------------------------------------------------


class drm_mode_card_res(ctypes.Structure):
    _fields_ = [
        ("fb_id_ptr", ctypes.c_uint64),
        ("crtc_id_ptr", ctypes.c_uint64),
        ("connector_id_ptr", ctypes.c_uint64),
        ("encoder_id_ptr", ctypes.c_uint64),
        ("count_fbs", ctypes.c_uint32),
        ("count_crtcs", ctypes.c_uint32),
        ("count_connectors", ctypes.c_uint32),
        ("count_encoders", ctypes.c_uint32),
        ("min_width", ctypes.c_uint32),
        ("max_width", ctypes.c_uint32),
        ("min_height", ctypes.c_uint32),
        ("max_height", ctypes.c_uint32),
    ]


class drm_mode_modeinfo(ctypes.Structure):
    _fields_ = [
        ("clock", ctypes.c_uint32),
        ("hdisplay", ctypes.c_uint16),
        ("hsync_start", ctypes.c_uint16),
        ("hsync_end", ctypes.c_uint16),
        ("htotal", ctypes.c_uint16),
        ("hskew", ctypes.c_uint16),
        ("vdisplay", ctypes.c_uint16),
        ("vsync_start", ctypes.c_uint16),
        ("vsync_end", ctypes.c_uint16),
        ("vtotal", ctypes.c_uint16),
        ("vscan", ctypes.c_uint16),
        ("vrefresh", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("name", ctypes.c_char * 32),
    ]


class drm_mode_get_connector(ctypes.Structure):
    _fields_ = [
        ("encoders_ptr", ctypes.c_uint64),
        ("modes_ptr", ctypes.c_uint64),
        ("props_ptr", ctypes.c_uint64),
        ("prop_values_ptr", ctypes.c_uint64),
        ("count_modes", ctypes.c_uint32),
        ("count_props", ctypes.c_uint32),
        ("count_encoders", ctypes.c_uint32),
        ("encoder_id", ctypes.c_uint32),
        ("connector_id", ctypes.c_uint32),
        ("connector_type", ctypes.c_uint32),
        ("connector_type_id", ctypes.c_uint32),
        ("connection", ctypes.c_uint32),
        ("mm_width", ctypes.c_uint32),
        ("mm_height", ctypes.c_uint32),
        ("subpixel", ctypes.c_uint32),
        ("pad", ctypes.c_uint32),
    ]


class drm_mode_get_encoder(ctypes.Structure):
    _fields_ = [
        ("encoder_id", ctypes.c_uint32),
        ("encoder_type", ctypes.c_uint32),
        ("crtc_id", ctypes.c_uint32),
        ("possible_crtcs", ctypes.c_uint32),
        ("possible_clones", ctypes.c_uint32),
    ]


class drm_mode_crtc(ctypes.Structure):
    _fields_ = [
        ("set_connectors_ptr", ctypes.c_uint64),
        ("count_connectors", ctypes.c_uint32),
        ("crtc_id", ctypes.c_uint32),
        ("fb_id", ctypes.c_uint32),
        ("x", ctypes.c_uint32),
        ("y", ctypes.c_uint32),
        ("gamma_size", ctypes.c_uint32),
        ("mode_valid", ctypes.c_uint32),
        ("mode", drm_mode_modeinfo),
    ]


class drm_mode_create_dumb(ctypes.Structure):
    _fields_ = [
        ("height", ctypes.c_uint32),
        ("width", ctypes.c_uint32),
        ("bpp", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("handle", ctypes.c_uint32),
        ("pitch", ctypes.c_uint32),
        ("size", ctypes.c_uint64),
    ]


class drm_mode_map_dumb(ctypes.Structure):
    _fields_ = [
        ("handle", ctypes.c_uint32),
        ("pad", ctypes.c_uint32),
        ("offset", ctypes.c_uint64),
    ]


class drm_mode_destroy_dumb(ctypes.Structure):
    _fields_ = [("handle", ctypes.c_uint32)]


class drm_mode_fb_cmd2(ctypes.Structure):
    _fields_ = [
        ("fb_id", ctypes.c_uint32),
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("pixel_format", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("handles", ctypes.c_uint32 * 4),
        ("pitches", ctypes.c_uint32 * 4),
        ("offsets", ctypes.c_uint32 * 4),
        ("modifier", ctypes.c_uint64 * 4),
    ]


def _IOWR(nr: int, size: int) -> int:
    return (3 << 30) | (size << 16) | (ord("d") << 8) | nr


DRM_IOCTL_MODE_GETRESOURCES = _IOWR(0xA0, ctypes.sizeof(drm_mode_card_res))
DRM_IOCTL_MODE_GETCRTC = _IOWR(0xA1, ctypes.sizeof(drm_mode_crtc))
DRM_IOCTL_MODE_SETCRTC = _IOWR(0xA2, ctypes.sizeof(drm_mode_crtc))
DRM_IOCTL_MODE_GETENCODER = _IOWR(0xA6, ctypes.sizeof(drm_mode_get_encoder))
DRM_IOCTL_MODE_GETCONNECTOR = _IOWR(0xA7, ctypes.sizeof(drm_mode_get_connector))
DRM_IOCTL_MODE_RMFB = _IOWR(0xAF, 4)
DRM_IOCTL_MODE_CREATE_DUMB = _IOWR(0xB2, ctypes.sizeof(drm_mode_create_dumb))
DRM_IOCTL_MODE_MAP_DUMB = _IOWR(0xB3, ctypes.sizeof(drm_mode_map_dumb))
DRM_IOCTL_MODE_DESTROY_DUMB = _IOWR(0xB4, ctypes.sizeof(drm_mode_destroy_dumb))
DRM_IOCTL_MODE_ADDFB2 = _IOWR(0xB8, ctypes.sizeof(drm_mode_fb_cmd2))

DRM_MODE_CONNECTED = 1
DRM_MODE_TYPE_PREFERRED = 1 << 3

# drm_fourcc.h
def _fourcc(a: str, b: str, c: str, d: str) -> int:
    return ord(a) | (ord(b) << 8) | (ord(c) << 16) | (ord(d) << 24)


DRM_FORMAT_XRGB8888 = _fourcc("X", "R", "2", "4")
DRM_FORMAT_UYVY = _fourcc("U", "Y", "V", "Y")

# connector type names (drm_mode.h DRM_MODE_CONNECTOR_*)
CONNECTOR_TYPE_NAMES = {
    0: "Unknown", 1: "VGA", 2: "DVI-I", 3: "DVI-D", 4: "DVI-A",
    5: "Composite", 6: "SVIDEO", 7: "LVDS", 8: "Component", 9: "DIN",
    10: "DP", 11: "HDMI-A", 12: "HDMI-B", 13: "TV", 14: "eDP",
    15: "Virtual", 16: "DSI", 17: "DPI", 18: "Writeback", 19: "SPI",
    20: "USB",
}


def probe_devices() -> List[str]:
    return sorted(glob.glob("/dev/dri/card*"))


def _u32_array(n: int):
    return (ctypes.c_uint32 * max(n, 1))()


class _DumbFB:
    """One dumb-buffer framebuffer: GEM handle + AddFB2 id + CPU mapping."""

    def __init__(self, fd: int, width: int, height: int, fourcc: int, bpp: int):
        self.fd = fd
        creq = drm_mode_create_dumb()
        creq.width, creq.height, creq.bpp = width, height, bpp
        _ioctl(fd, DRM_IOCTL_MODE_CREATE_DUMB, creq)
        self.handle, self.pitch, self.size = creq.handle, creq.pitch, creq.size

        fb2 = drm_mode_fb_cmd2()
        fb2.width, fb2.height, fb2.pixel_format = width, height, fourcc
        fb2.handles[0], fb2.pitches[0] = self.handle, self.pitch
        try:
            _ioctl(fd, DRM_IOCTL_MODE_ADDFB2, fb2)
        except OSError:
            dreq = drm_mode_destroy_dumb()
            dreq.handle = self.handle
            _ioctl(fd, DRM_IOCTL_MODE_DESTROY_DUMB, dreq)
            raise
        self.fb_id = fb2.fb_id

        mreq = drm_mode_map_dumb()
        mreq.handle = self.handle
        _ioctl(fd, DRM_IOCTL_MODE_MAP_DUMB, mreq)
        self.map = mmap.mmap(fd, self.size, mmap.MAP_SHARED,
                             mmap.PROT_READ | mmap.PROT_WRITE,
                             offset=mreq.offset)
        # [height, pitch] byte view of the scanout buffer (size is page-
        # rounded by the kernel, so slice before reshaping)
        self.view = np.frombuffer(self.map, np.uint8)[: height * self.pitch
                                                      ].reshape(height, self.pitch)

    def destroy(self) -> None:
        self.view = None
        self.map.close()
        try:
            _ioctl(self.fd, DRM_IOCTL_MODE_RMFB, ctypes.c_uint32(self.fb_id))
            dreq = drm_mode_destroy_dumb()
            dreq.handle = self.handle
            _ioctl(self.fd, DRM_IOCTL_MODE_DESTROY_DUMB, dreq)
        except OSError:
            pass


class DrmDisplay(VideoDisplay):
    """Scan frames out a KMS CRTC via dumb framebuffers (``-d drm``)."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        dev: Optional[str] = None
        self.req_connector: Optional[str] = None
        self.req_mode: Optional[Tuple[int, int, int]] = None  # w, h, rate(0=any)
        for tok in filter(None, cfg.split(":")):
            key, _, val = tok.partition("=")
            if key == "dev":
                dev = val
            elif key == "connector":
                self.req_connector = val
            elif key == "mode":
                res, _, rate = val.partition("@")
                w, _, h = res.partition("x")
                self.req_mode = (int(w), int(h), int(rate or 0))
        if dev is None:
            devs = probe_devices()
            if not devs:
                raise RuntimeError("drm: no /dev/dri/card* device present (probe failed)")
            dev = devs[0]
        self.fd = _open(dev, os.O_RDWR)

        conn, mode = self._pick_connector_mode()
        self.connector_id = conn.connector_id
        self.mode = mode
        cname = (f"{CONNECTOR_TYPE_NAMES.get(conn.connector_type, '?')}"
                 f"-{conn.connector_type_id}")
        log.notice(f"{dev}: {cname} {mode.hdisplay}x{mode.vdisplay}"
                   f"@{mode.vrefresh}")

        # CRTC: from the connector's current encoder, else the first one
        crtc_id = 0
        if conn.encoder_id:
            enc = drm_mode_get_encoder()
            enc.encoder_id = conn.encoder_id
            _ioctl(self.fd, DRM_IOCTL_MODE_GETENCODER, enc)
            crtc_id = enc.crtc_id
        if not crtc_id:
            crtc_id = self._first_crtc_id()
        self.crtc_id = crtc_id

        # save original CRTC config for restoration at done()
        self.saved_crtc = drm_mode_crtc()
        self.saved_crtc.crtc_id = crtc_id
        _ioctl(self.fd, DRM_IOCTL_MODE_GETCRTC, self.saved_crtc)

        # probe UYVY dumb-fb support (ref probes plane formats; AddFB2 is the
        # authoritative accept/reject for dumb buffers)
        self.uyvy_ok = False
        try:
            probe = _DumbFB(self.fd, 64, 64, DRM_FORMAT_UYVY, 16)
            probe.destroy()
            self.uyvy_ok = True
        except OSError:
            pass

        self.front: Optional[_DumbFB] = None
        self.back: Optional[_DumbFB] = None
        self.fb_fourcc = DRM_FORMAT_XRGB8888

    # -- KMS discovery ---------------------------------------------------

    def _resources(self) -> Tuple[List[int], List[int]]:
        res = drm_mode_card_res()
        _ioctl(self.fd, DRM_IOCTL_MODE_GETRESOURCES, res)
        conns = _u32_array(res.count_connectors)
        crtcs = _u32_array(res.count_crtcs)
        res2 = drm_mode_card_res()
        res2.count_connectors = res.count_connectors
        res2.count_crtcs = res.count_crtcs
        res2.connector_id_ptr = ctypes.addressof(conns)
        res2.crtc_id_ptr = ctypes.addressof(crtcs)
        _ioctl(self.fd, DRM_IOCTL_MODE_GETRESOURCES, res2)
        return (list(conns[: res2.count_connectors]),
                list(crtcs[: res2.count_crtcs]))

    def _get_connector(self, cid: int):
        conn = drm_mode_get_connector()
        conn.connector_id = cid
        _ioctl(self.fd, DRM_IOCTL_MODE_GETCONNECTOR, conn)
        modes = (drm_mode_modeinfo * max(conn.count_modes, 1))()
        conn2 = drm_mode_get_connector()
        conn2.connector_id = cid
        conn2.count_modes = conn.count_modes
        conn2.modes_ptr = ctypes.addressof(modes)
        _ioctl(self.fd, DRM_IOCTL_MODE_GETCONNECTOR, conn2)
        return conn2, list(modes[: conn2.count_modes])

    def _pick_connector_mode(self):
        conn_ids, _ = self._resources()
        for cid in conn_ids:
            conn, modes = self._get_connector(cid)
            if conn.connection != DRM_MODE_CONNECTED or not modes:
                continue
            cname = (f"{CONNECTOR_TYPE_NAMES.get(conn.connector_type, '?')}"
                     f"-{conn.connector_type_id}")
            if self.req_connector and cname != self.req_connector:
                continue
            mode = self._pick_mode(modes)
            if mode is not None:
                return conn, mode
        raise RuntimeError(
            f"drm: no connected connector"
            + (f" named {self.req_connector!r}" if self.req_connector else "")
        )

    def _pick_mode(self, modes):
        if self.req_mode:
            w, h, rate = self.req_mode
            for m in modes:
                if (m.hdisplay, m.vdisplay) == (w, h) and rate in (0, m.vrefresh):
                    return m
            return None
        for m in modes:
            if m.type & DRM_MODE_TYPE_PREFERRED:
                return m
        return modes[0]

    def _first_crtc_id(self) -> int:
        _, crtc_ids = self._resources()
        if not crtc_ids:
            raise RuntimeError("drm: device has no CRTCs")
        return crtc_ids[0]

    # -- display contract --------------------------------------------------

    def get_property_codecs(self) -> List[Codec]:
        codecs = [Codec.RGBA, Codec.RGB]
        if self.uyvy_ok:
            codecs.append(Codec.UYVY)
        return codecs

    def reconfigure(self, desc: VideoDesc) -> bool:
        for fb in (self.front, self.back):
            if fb is not None:
                fb.destroy()
        use_uyvy = desc.color_spec == Codec.UYVY and self.uyvy_ok
        self.fb_fourcc = DRM_FORMAT_UYVY if use_uyvy else DRM_FORMAT_XRGB8888
        bpp = 16 if use_uyvy else 32
        w, h = self.mode.hdisplay, self.mode.vdisplay
        self.front = _DumbFB(self.fd, w, h, self.fb_fourcc, bpp)
        self.back = _DumbFB(self.fd, w, h, self.fb_fourcc, bpp)
        self.desc = desc
        self._set_crtc(self.front.fb_id)
        return True

    def _set_crtc(self, fb_id: int) -> None:
        conn_arr = ctypes.c_uint32(self.connector_id)
        crtc = drm_mode_crtc()
        crtc.crtc_id = self.crtc_id
        crtc.fb_id = fb_id
        crtc.set_connectors_ptr = ctypes.addressof(conn_arr)
        crtc.count_connectors = 1
        crtc.mode = self.mode
        crtc.mode_valid = 1
        _ioctl(self.fd, DRM_IOCTL_MODE_SETCRTC, crtc)

    def _frame_scanout_bytes(self, frame: VideoFrame) -> np.ndarray:
        """Frame -> [h, bytes_per_row] in the framebuffer's pixel layout,
        laid out on the frame's device and downloaded once."""
        desc = frame.desc
        data = torch.as_tensor(frame.data)
        w, h = desc.width, desc.height
        if self.fb_fourcc == DRM_FORMAT_UYVY:
            return _host_bytes(data[:, : 2 * w])
        if desc.color_spec == Codec.RGB:
            rgb = data[:, : 3 * w].reshape(h, w, 3)
        elif desc.color_spec == Codec.RGBA:
            rgb = data[:, : 4 * w].reshape(h, w, 4)[:, :, :3]
        else:
            raise RuntimeError(f"drm: cannot scan out {desc.color_spec.name}")
        px = torch.zeros((h, w, 4), dtype=torch.uint8, device=data.device)  # little-endian XRGB: B G R X
        px[:, :, :3] = rgb.flip(2)
        return _host_bytes(px.reshape(h, 4 * w))

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is None or self.back is None:
            return
        rows = self._frame_scanout_bytes(frame)
        fb = self.back
        bpx = 2 if self.fb_fourcc == DRM_FORMAT_UYVY else 4
        fw, fh = self.mode.hdisplay, self.mode.vdisplay
        h = min(rows.shape[0], fh)
        wb = min(rows.shape[1], fw * bpx)
        y0 = (fh - h) // 2
        # centering aligned to 4 bytes: 1 XRGB pixel / 1 UYVY macropixel
        # (keeps UYVY chroma phase)
        x0 = ((fw * bpx - wb) // 2) & ~3
        fb.view[y0:y0 + h, x0:x0 + wb] = rows[:h, :wb]
        self._set_crtc(fb.fb_id)
        self.front, self.back = fb, self.front
        super().put_frame(frame, blocking)

    def done(self) -> None:
        try:
            if self.saved_crtc.mode_valid or self.saved_crtc.fb_id:
                conn_arr = ctypes.c_uint32(self.connector_id)
                self.saved_crtc.set_connectors_ptr = ctypes.addressof(conn_arr)
                self.saved_crtc.count_connectors = 1
                _ioctl(self.fd, DRM_IOCTL_MODE_SETCRTC, self.saved_crtc)
        except OSError as e:
            log.error(f"failed to restore original crtc: {e}")
        for fb in (self.front, self.back):
            if fb is not None:
                fb.destroy()
        os.close(self.fd)


register_module("drm", LibraryClass.VIDEO_DISPLAY, DrmDisplay)
