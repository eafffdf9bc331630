"""File capture and display modules (raw sequences and Y4M), and the
capture and display combinators: aggregate, switcher, swmix, multiplier.

The port of ``ultragrid_tpu/modules/file_io.py`` (ref: src/video_capture/
file.c, src/video_display/file.cpp, video_capture/aggregate.c, switcher.c,
swmix.c, video_display/multiplier.cpp).  A file is read on the host and each
frame uploaded once to the capture's device (the card unless the caller
names another); Y4M carries I420, which the ``y4m`` display makes from UYVY
on the frame's device (``ops/planar.py``) and copies to the host once.
``swmix`` converts, scales and composites its inputs on its device.  A file
that is neither raw (``file:PATH:WxH:FPS:CODEC``) nor Y4M is any container
that libavformat reads (ref: video_capture/file.c is libavformat-based for
exactly this), through the shim of ``modules/lavc.py``: decoded to UYVY on
the host and uploaded once, as the other files are; without libavcodec it
is refused with an error that names it.
"""

from __future__ import annotations

import ctypes
import time

import numpy as np
import torch

from ultragrid_tpu_torch import native
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_capture import VideoCapture, initialize_video_capture
from ultragrid_tpu_torch.modules.video_display import VideoDisplay, initialize_video_display
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.ops.planar import uyvy_to_i420
from ultragrid_tpu_torch.ops.postprocess import scale_bilinear_rgb
from ultragrid_tpu_torch.types import (Codec, VideoDesc, VideoFrame, get_codec_from_name, vc_get_datalen,
                                       vc_get_linesize)
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("file")


def _upload(raw: bytes, shape, device: torch.device) -> torch.Tensor:
    """Host bytes -> a uint8 tensor of ``shape`` on ``device`` (one copy)."""
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).reshape(shape).to(device)


class RawFileCapture(VideoCapture):
    """file:PATH:WxH:FPS:CODEC — raw concatenated frames; Y4M auto-detected."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        parts = cfg.split(":")
        self.path = parts[0]
        self._lavf = None
        self._fh = open(self.path, "rb")
        magic = self._fh.read(9)
        self._fh.seek(0)
        if magic == b"YUV4MPEG2":
            self._init_y4m()
        elif len(parts) >= 4 and "x" in parts[1]:
            w, _, h = parts[1].partition("x")
            self.desc = VideoDesc(int(w), int(h), get_codec_from_name(parts[3]), float(parts[2]))
            self._y4m = False
        else:
            self._fh.close()
            self._fh = None
            self._init_lavf()
        self.count = 0
        self.start = None
        self.loop = "loop" in parts

    def _init_lavf(self) -> None:
        if not native.lavc_headers_present():
            raise ValueError(f"cannot read {self.path!r}: a container file needs libavformat, and libavcodec's "
                             "FFmpeg headers are absent; give file:PATH:WxH:FPS:CODEC for raw frames, or a Y4M file")
        lib = native.lavc_shim_lib()
        h = lib.lavf_open(self.path.encode())
        if not h:
            raise ValueError(f"libavformat cannot open {self.path!r}")
        w, hh, fps = ctypes.c_int(), ctypes.c_int(), ctypes.c_double()
        lib.lavf_info(h, ctypes.byref(w), ctypes.byref(hh), ctypes.byref(fps))
        self._lavf = (lib, h)
        self._y4m = False
        self.desc = VideoDesc(w.value, hh.value, Codec.UYVY, fps.value or 30.0)
        self._lavf_buf = np.empty(w.value * hh.value * 2, np.uint8)

    def _init_y4m(self) -> None:
        header = b""
        while not header.endswith(b"\n"):
            header += self._fh.read(1)
        w = h = 0
        fps = 25.0
        for f in header.decode().strip().split(" ")[1:]:
            if f.startswith("W"):
                w = int(f[1:])
            elif f.startswith("H"):
                h = int(f[1:])
            elif f.startswith("F"):
                num, den = f[1:].split(":")
                fps = int(num) / int(den)
        self.desc = VideoDesc(w, h, Codec.I420, fps)
        self._y4m = True

    def grab(self):
        now = time.monotonic()
        if self.start is None:
            self.start = now
        deadline = self.start + self.count / self.desc.fps
        if now < deadline:
            time.sleep(deadline - now)
        if self._lavf is not None:
            lib, h = self._lavf
            n = lib.lavf_read_frame(h, 0, self._lavf_buf.ctypes.data, self._lavf_buf.size)
            if n <= 0:
                return self._eof()
            self.count += 1
            data = torch.from_numpy(self._lavf_buf[:n].reshape(self.desc.height, self.desc.width * 2))
            frame = VideoFrame(self.desc, [data.to(self.device, copy=True)])
            frame.timestamp = now
            return frame, None
        if self._y4m:
            line = b""
            while not line.endswith(b"\n"):
                b = self._fh.read(1)
                if not b:
                    return self._eof()
                line += b
            if not line.startswith(b"FRAME"):
                raise ValueError(f"{self.path!r}: Y4M frame header expected, got {line[:16]!r}")
            n = vc_get_datalen(self.desc.width, self.desc.height, Codec.I420)
            shape = (n,)
        else:
            ls = vc_get_linesize(self.desc.width, self.desc.color_spec)
            n = ls * self.desc.height
            shape = (self.desc.height, ls)
        raw = self._fh.read(n)
        if len(raw) < n:
            return self._eof()
        self.count += 1
        frame = VideoFrame(self.desc, [_upload(raw, shape, self.device)])
        frame.timestamp = now
        return frame, None

    def _eof(self):
        if self.loop:
            if self._lavf is not None:
                lib, h = self._lavf
                lib.lavf_seek_start(h)
                return self.grab()
            self._fh.seek(0)
            if self._y4m:
                self._init_y4m()
            return self.grab()
        return None, None

    def done(self) -> None:
        if self._fh is not None:
            self._fh.close()
        if self._lavf is not None:
            lib, h = self._lavf
            lib.lavf_close(h)
            self._lavf = None


class Y4mDisplay(VideoDisplay):
    """Writes received frames as a Y4M stream (UYVY converted to I420)."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.path = cfg or "out.y4m"
        self._fh = None

    def get_property_codecs(self):
        return [Codec.UYVY, Codec.I420]

    def reconfigure(self, desc: VideoDesc) -> bool:
        super().reconfigure(desc)
        if self._fh is not None:
            self._fh.close()
        self._fh = open(self.path, "wb")
        num = int(round(desc.fps * 1000))
        self._fh.write(f"YUV4MPEG2 W{desc.width} H{desc.height} F{num}:1000 Ip A1:1 C420jpeg\n".encode())
        return True

    def put_frame(self, frame, blocking: bool = True) -> None:
        if frame is None:
            return
        super().put_frame(frame, blocking)
        data = frame.data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
        if frame.desc.color_spec == Codec.UYVY:
            data = uyvy_to_i420(data, frame.desc.width, frame.desc.height)
        self._fh.write(b"FRAME\n")
        self._fh.write(data.cpu().numpy().tobytes())

    def done(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class MultiplierDisplay(VideoDisplay):
    """Fan-out of one stream to several displays (ref:
    video_display/multiplier.cpp).  Config: ``multiplier:disp1#disp2#...``."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.children = [initialize_video_display(spec, device=device) for spec in cfg.split("#") if spec]
        # a pooled frame handed to any retaining child must not be recycled
        self.retains_frames = any(c.retains_frames for c in self.children)

    def get_property_codecs(self):
        codecs = None
        for c in self.children:
            own = set(c.get_property_codecs())
            codecs = own if codecs is None else codecs & own
        return sorted(codecs or [], key=int)

    def reconfigure(self, desc: VideoDesc) -> bool:
        super().reconfigure(desc)
        return all(c.reconfigure(desc) for c in self.children)

    def put_frame(self, frame, blocking: bool = True) -> None:
        if frame is None:
            return
        super().put_frame(frame, blocking)
        for c in self.children:
            c.put_frame(frame, blocking)

    def done(self) -> None:
        for c in self.children:
            c.done()


class AggregateCapture(VideoCapture):
    """N capture devices -> N-tile frames (ref: video_capture/aggregate.c).
    Config: ``aggregate:dev1#dev2``."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.children = [initialize_video_capture(spec, device=device) for spec in cfg.split("#") if spec]
        if not self.children:
            raise ValueError("aggregate: no input devices given")
        self.desc = self.children[0].desc.with_(tile_count=len(self.children))

    def grab(self):
        tiles = []
        audio = None
        for c in self.children:
            f, a = c.grab()
            if f is None:
                return None, None
            tiles.append(f.data)
            audio = audio or a
        frame = VideoFrame(self.desc, tiles)
        frame.timestamp = time.monotonic()
        return frame, audio

    def done(self) -> None:
        for c in self.children:
            c.done()


class SwitcherCapture(VideoCapture):
    """Runtime-switchable input selector (ref: video_capture/switcher.c).
    Config: ``switcher:dev1#dev2``; switch with ``select(i)``."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.children = [initialize_video_capture(spec, device=device) for spec in cfg.split("#") if spec]
        if not self.children:
            raise ValueError("switcher: no input devices given")
        self.current = 0
        self.desc = self.children[0].desc

    def select(self, index: int) -> bool:
        if 0 <= index < len(self.children):
            self.current = index
            self.desc = self.children[index].desc
            return True
        return False

    def grab(self):
        # every input is drained to keep it paced; the selected one is sent
        result = None
        for i, c in enumerate(self.children):
            f, a = c.grab()
            if i == self.current:
                result = (f, a)
        return result if result else (None, None)

    def done(self) -> None:
        for c in self.children:
            c.done()


class SwmixCapture(VideoCapture):
    """Software video mixer: N sub-captures composited into one frame (ref:
    src/video_capture/swmix.c).

    Config: ``swmix:<W>:<H>:<fps>[:<codec>][:layout=<X>x<Y>]#dev1#dev2...``.
    Inputs are converted to RGB, bilinearly scaled into grid cells and
    composited on the capture's device.
    """

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        head, *devs = cfg.split("#")
        parts = [p for p in head.split(":") if p]
        if len(parts) < 3:
            raise ValueError("usage: swmix:<W>:<H>:<fps>[:<codec>][:layout=XxY]#dev1#dev2...")
        self.width, self.height = int(parts[0]), int(parts[1])
        fps_s = parts[2]
        self.fps = float(fps_s[:-1]) if fps_s.endswith("i") else float(fps_s)
        self.out_codec = Codec.RGB
        self.layout = None
        for tok in parts[3:]:
            if tok.startswith("layout="):
                x, _, y = tok[7:].partition("x")
                self.layout = (int(x), int(y))
            elif tok.startswith("interpolation="):
                pass  # bilinear resample (bicubic is a GL shader path)
            else:
                self.out_codec = get_codec_from_name(tok)
        if not devs:
            raise ValueError("swmix: no input devices given")
        self.children = [initialize_video_capture(s, device=device) for s in devs]
        n = len(self.children)
        if self.layout is None:
            gx = int(np.ceil(np.sqrt(n)))
            self.layout = (gx, int(np.ceil(n / gx)))
        self.desc = VideoDesc(self.width, self.height, self.out_codec, self.fps)

    def grab(self):
        gx, gy = self.layout
        cw, ch = self.width // gx, self.height // gy
        canvas = torch.zeros((self.height, 3 * self.width), dtype=torch.uint8, device=self.device)
        audio = None
        for i, child in enumerate(self.children):
            f, a = child.grab()
            audio = audio or a
            if f is None:
                continue
            d = f.desc
            rgb = f.data
            if d.color_spec != Codec.RGB:
                rgb = pixfmt.convert_frame(rgb, d.width, d.color_spec, Codec.RGB)
            cell = scale_bilinear_rgb(rgb, d.width, Codec.RGB, cw, ch)
            x, y = (i % gx) * cw, (i // gx) * ch
            canvas[y: y + ch, 3 * x: 3 * (x + cw)] = cell
        data = canvas
        if self.out_codec != Codec.RGB:
            data = pixfmt.convert_frame(canvas, self.width, Codec.RGB, self.out_codec)
        frame = VideoFrame(self.desc, [data])
        frame.timestamp = time.monotonic()
        return frame, audio

    def done(self) -> None:
        for c in self.children:
            c.done()


register_module("file", LibraryClass.VIDEO_CAPTURE, RawFileCapture)
register_module("y4m", LibraryClass.VIDEO_DISPLAY, Y4mDisplay)
register_module("multiplier", LibraryClass.VIDEO_DISPLAY, MultiplierDisplay)
register_module("aggregate", LibraryClass.VIDEO_CAPTURE, AggregateCapture)
register_module("switcher", LibraryClass.VIDEO_CAPTURE, SwitcherCapture)
register_module("swmix", LibraryClass.VIDEO_CAPTURE, SwmixCapture)
