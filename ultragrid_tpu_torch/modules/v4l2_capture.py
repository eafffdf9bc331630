"""V4L2 capture module (Linux webcams / capture cards).

The port of ``ultragrid_tpu/modules/v4l2_capture.py`` (ref:
src/video_capture/v4l2.c): device probing (QUERYCAP), format negotiation
preferring native UYVY/YUYV, mmap streaming I/O (REQBUFS/QBUF/STREAMON/DQBUF),
fps via S_PARM.  Pure ctypes against the kernel UAPI, with the reference's
struct layouts and ``PIXFMT_MAP``; no libv4l dependency.  Each dequeued
buffer is copied out of the mmap and uploaded once to the capture's device
(the card unless the caller names another).  In environments without
/dev/video* the module registers and init fails with the reference's probe
message (the reference behaves the same without a device).

Config: ``-t v4l2[:dev=/dev/video0][:size=WxH][:fps=N][:codec=UYVY]``.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import mmap
import os
import select
from typing import List, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_capture import VideoCapture
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, get_codec_from_name
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("vidcap.v4l2")


# ---------------------------------------------------------------------------
# UAPI structs (videodev2.h); ctypes handles the 64-bit layout/alignment
# ---------------------------------------------------------------------------


class v4l2_capability(ctypes.Structure):
    _fields_ = [
        ("driver", ctypes.c_uint8 * 16),
        ("card", ctypes.c_uint8 * 32),
        ("bus_info", ctypes.c_uint8 * 32),
        ("version", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("device_caps", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32 * 3),
    ]


class v4l2_pix_format(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("pixelformat", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("bytesperline", ctypes.c_uint32),
        ("sizeimage", ctypes.c_uint32),
        ("colorspace", ctypes.c_uint32),
        ("priv", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("ycbcr_enc", ctypes.c_uint32),
        ("quantization", ctypes.c_uint32),
        ("xfer_func", ctypes.c_uint32),
    ]


class _fmt_union(ctypes.Union):
    # the kernel union holds pointer-bearing members (v4l2_window), making
    # it 8-aligned on 64-bit; _align reproduces that so sizeof == 208
    _fields_ = [
        ("pix", v4l2_pix_format),
        ("raw_data", ctypes.c_uint8 * 200),
        ("_align", ctypes.c_void_p),
    ]


class v4l2_format(ctypes.Structure):
    _anonymous_ = ("fmt",)
    _fields_ = [("type", ctypes.c_uint32), ("fmt", _fmt_union)]


class v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("flags", ctypes.c_uint8),
        ("reserved", ctypes.c_uint8 * 3),
    ]


class v4l2_timecode(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("frames", ctypes.c_uint8),
        ("seconds", ctypes.c_uint8),
        ("minutes", ctypes.c_uint8),
        ("hours", ctypes.c_uint8),
        ("userbits", ctypes.c_uint8 * 4),
    ]


class timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _buf_m(ctypes.Union):
    _fields_ = [
        ("offset", ctypes.c_uint32),
        ("userptr", ctypes.c_ulong),
        ("planes", ctypes.c_void_p),
        ("fd", ctypes.c_int32),
    ]


class v4l2_buffer(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("bytesused", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("timestamp", timeval),
        ("timecode", v4l2_timecode),
        ("sequence", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("m", _buf_m),
        ("length", ctypes.c_uint32),
        ("reserved2", ctypes.c_uint32),
        ("request_fd", ctypes.c_uint32),
    ]


class v4l2_fract(ctypes.Structure):
    _fields_ = [("numerator", ctypes.c_uint32), ("denominator", ctypes.c_uint32)]


class v4l2_captureparm(ctypes.Structure):
    _fields_ = [
        ("capability", ctypes.c_uint32),
        ("capturemode", ctypes.c_uint32),
        ("timeperframe", v4l2_fract),
        ("extendedmode", ctypes.c_uint32),
        ("readbuffers", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32 * 4),
    ]


class _parm_union(ctypes.Union):
    _fields_ = [("capture", v4l2_captureparm), ("raw_data", ctypes.c_uint8 * 200)]


class v4l2_streamparm(ctypes.Structure):
    _anonymous_ = ("parm",)
    _fields_ = [("type", ctypes.c_uint32), ("parm", _parm_union)]


def _IOC(direction: int, typ: str, nr: int, size: int) -> int:
    return (direction << 30) | (size << 16) | (ord(typ) << 8) | nr


_IOC_W, _IOC_R, _IOC_RW = 1, 2, 3
VIDIOC_QUERYCAP = _IOC(_IOC_R, "V", 0, ctypes.sizeof(v4l2_capability))
VIDIOC_S_FMT = _IOC(_IOC_RW, "V", 5, ctypes.sizeof(v4l2_format))
VIDIOC_REQBUFS = _IOC(_IOC_RW, "V", 8, ctypes.sizeof(v4l2_requestbuffers))
VIDIOC_QUERYBUF = _IOC(_IOC_RW, "V", 9, ctypes.sizeof(v4l2_buffer))
VIDIOC_QBUF = _IOC(_IOC_RW, "V", 15, ctypes.sizeof(v4l2_buffer))
VIDIOC_DQBUF = _IOC(_IOC_RW, "V", 17, ctypes.sizeof(v4l2_buffer))
VIDIOC_STREAMON = _IOC(_IOC_W, "V", 18, 4)
VIDIOC_STREAMOFF = _IOC(_IOC_W, "V", 19, 4)
VIDIOC_S_PARM = _IOC(_IOC_RW, "V", 22, ctypes.sizeof(v4l2_streamparm))

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_CAP_VIDEO_CAPTURE = 0x00000001
V4L2_CAP_STREAMING = 0x04000000
V4L2_FIELD_NONE = 1


def _fourcc(a, b, c, d) -> int:
    return ord(a) | (ord(b) << 8) | (ord(c) << 16) | (ord(d) << 24)


# V4L2 pixelformat <-> our codec (subset the pipeline consumes natively)
PIXFMT_MAP = {
    Codec.UYVY: _fourcc("U", "Y", "V", "Y"),
    Codec.YUYV: _fourcc("Y", "U", "Y", "V"),
    Codec.RGB: _fourcc("R", "G", "B", "3"),
    Codec.BGR: _fourcc("B", "G", "R", "3"),
}


def probe_devices() -> List[str]:
    return sorted(glob.glob("/dev/video*"))


class V4l2Capture(VideoCapture):
    N_BUFFERS = 4

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        dev = None
        width, height, fps = 640, 480, 30.0
        codec = Codec.UYVY
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key in ("dev", "device"):
                dev = val
            elif key in ("s", "size"):
                w, _, h = val.partition("x")
                width, height = int(w), int(h)
            elif key in ("f", "fps"):
                fps = float(val)
            elif key in ("c", "codec"):
                codec = get_codec_from_name(val)
        if dev is None:
            devs = probe_devices()
            if not devs:
                raise RuntimeError(
                    "v4l2: no /dev/video* device present (probe failed)"
                )
            dev = devs[0]
        self.fd = os.open(dev, os.O_RDWR | os.O_NONBLOCK)

        cap = v4l2_capability()
        fcntl.ioctl(self.fd, VIDIOC_QUERYCAP, cap)
        if not (cap.device_caps or cap.capabilities) & V4L2_CAP_VIDEO_CAPTURE:
            raise RuntimeError(f"v4l2: {dev} is not a capture device")
        card = bytes(cap.card).split(b"\0", 1)[0].decode(errors="replace")
        log.notice(f"{dev}: {card}")

        fmt = v4l2_format()
        fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        fmt.pix.width = width
        fmt.pix.height = height
        fmt.pix.pixelformat = PIXFMT_MAP.get(codec, PIXFMT_MAP[Codec.UYVY])
        fmt.pix.field = V4L2_FIELD_NONE
        fcntl.ioctl(self.fd, VIDIOC_S_FMT, fmt)
        got_fourcc = fmt.pix.pixelformat
        rev = {v: k for k, v in PIXFMT_MAP.items()}
        if got_fourcc not in rev:
            raise RuntimeError(
                f"v4l2: driver insists on unsupported pixelformat 0x{got_fourcc:08x}"
            )
        self.codec = rev[got_fourcc]
        self.width, self.height = fmt.pix.width, fmt.pix.height
        self.linesize = fmt.pix.bytesperline
        self.sizeimage = fmt.pix.sizeimage

        parm = v4l2_streamparm()
        parm.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        parm.capture.timeperframe.numerator = 1000
        parm.capture.timeperframe.denominator = int(fps * 1000)
        try:
            fcntl.ioctl(self.fd, VIDIOC_S_PARM, parm)
            tpf = parm.capture.timeperframe
            if tpf.numerator:
                fps = tpf.denominator / tpf.numerator
        except OSError:
            pass
        self.fps = fps

        req = v4l2_requestbuffers()
        req.count = self.N_BUFFERS
        req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        req.memory = V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, VIDIOC_REQBUFS, req)
        self.maps = []
        for i in range(req.count):
            buf = v4l2_buffer()
            buf.index = i
            buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            buf.memory = V4L2_MEMORY_MMAP
            fcntl.ioctl(self.fd, VIDIOC_QUERYBUF, buf)
            m = mmap.mmap(self.fd, buf.length, mmap.MAP_SHARED,
                          mmap.PROT_READ | mmap.PROT_WRITE, offset=buf.m.offset)
            self.maps.append(m)
            fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
        fcntl.ioctl(self.fd, VIDIOC_STREAMON,
                    ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
        self.desc = VideoDesc(self.width, self.height, self.codec, self.fps)
        log.notice(
            f"streaming {self.width}x{self.height} {self.codec.name} @{self.fps:g}"
        )

    def grab(self) -> Tuple[Optional[VideoFrame], Optional[object]]:
        r, _, _ = select.select([self.fd], [], [], 2.0)
        if not r:
            return None, None
        buf = v4l2_buffer()
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = V4L2_MEMORY_MMAP
        try:
            fcntl.ioctl(self.fd, VIDIOC_DQBUF, buf)
        except OSError:
            return None, None
        n = buf.bytesused or self.sizeimage
        data = np.frombuffer(self.maps[buf.index], np.uint8, count=n).copy()
        fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
        stride = self.linesize or (n // self.height)
        plane = torch.from_numpy(data[: stride * self.height].reshape(self.height, stride))
        frame = VideoFrame(self.desc, [plane.to(self.device)])
        frame.timestamp = buf.timestamp.tv_sec + buf.timestamp.tv_usec / 1e6
        return frame, None

    def done(self) -> None:
        try:
            fcntl.ioctl(self.fd, VIDIOC_STREAMOFF,
                        ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for m in self.maps:
            m.close()
        os.close(self.fd)


register_module("v4l2", LibraryClass.VIDEO_CAPTURE, V4l2Capture)
