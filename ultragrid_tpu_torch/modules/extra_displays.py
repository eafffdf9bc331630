"""Terminal (caca-style), panorama, pipe, aggregate and blend displays on tensors.

Port of ``ultragrid_tpu/modules/extra_displays.py``, counterparts of five
reference display modules:

* ``caca`` — terminal ASCII/ANSI renderer (ref: src/video_display/caca.c,
  which dithers through libcaca).  The frame is converted and sampled down
  to the terminal cell grid on its device; only the small grid comes to the
  host, to be written as 24-bit-color half-block glyphs (two pixels per
  character cell), no external library.
* ``pano`` — 360° equirectangular viewer (ref: src/video_display/pano_gl.cpp
  — a GL sphere renderer).  The rectilinear view is a gather over the
  equirect frame on its device, its coordinates computed once on the host
  (float64, as the JAX package computes them); forwarded to any child
  display.
* ``pipe`` — delivers frames to an in-process delegate
  (ref: src/video_display/pipe.c, which smuggles a C delegate pointer
  through the fmt string; here delegates register by key).
* ``aggregate`` — one tile per child display
  (ref: src/video_display/aggregate.c).
* ``blend`` — crossfade on a sender switch (ref: src/video_display/blend.cpp).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_display import VideoDisplay, initialize_video_display
from ultragrid_tpu_torch.ops.pixfmt import convert_frame
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("display")


def _tile_to_rgb(tile: torch.Tensor, desc: VideoDesc) -> torch.Tensor:
    """Any pixfmt tile -> uint8 [H, W, 3] on the tile's device."""
    rgb = tile if desc.color_spec == Codec.RGB else convert_frame(tile, desc.width, desc.color_spec, Codec.RGB)
    return rgb[:, : desc.width * 3].reshape(desc.height, desc.width, 3)


class CacaDisplay(VideoDisplay):
    """``caca[:driver=<drv>][:size=COLSxROWS][:out=PATH]``

    Renders frames into the terminal as 24-bit ANSI half-blocks: each
    character cell shows two vertically stacked pixels via ``▀`` with
    foreground = top pixel and background = bottom pixel.  ``driver`` is
    accepted for reference-grammar compatibility (only the ANSI renderer
    exists); ``size`` overrides the detected terminal size; ``out`` writes
    the escape stream to a file (tests / piping to another terminal).
    """

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.cols, self.rows = 0, 0
        self.out_path: Optional[str] = None
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "size":
                c, _, r = val.partition("x")
                self.cols, self.rows = int(c), int(r)
            elif key == "out":
                self.out_path = val
            elif key == "driver":
                if val not in ("ansi", "utf8", ""):
                    log.warning(f"caca: only the ansi driver exists, got {val!r}")
            elif key == "help":
                print("caca display: caca[:driver=ansi][:size=COLSxROWS][:out=PATH]")
        if not self.cols:
            try:
                ts = os.get_terminal_size()
                self.cols, self.rows = ts.columns, max(ts.lines - 1, 1)
            except OSError:
                self.cols, self.rows = 80, 24
        self._fh = None
        self._grid: Optional[tuple] = None  # (sy, sx) sample indices for the current desc

    def _emit(self, text: str) -> None:
        if self.out_path is not None:
            if self._fh is None:
                self._fh = open(self.out_path, "w")
            self._fh.write(text)
            self._fh.flush()
        else:
            sys.stdout.write(text)
            sys.stdout.flush()

    def reconfigure(self, desc: VideoDesc) -> bool:
        super().reconfigure(desc)
        # target pixel grid: cols x 2*rows, aspect-preserving nearest sample.
        # Terminal cells are ~1:2, half-blocks make the pixel aspect ~1:1.
        pw, ph = self.cols, self.rows * 2
        scale = min(pw / desc.width, ph / desc.height)
        self.ow = max(2, int(desc.width * scale)) & ~1
        self.oh = max(2, int(desc.height * scale)) & ~1
        w, h, ow, oh = desc.width, desc.height, self.ow, self.oh
        self._grid = (np.arange(oh) * h // oh, np.arange(ow) * w // ow)
        self._emit("\x1b[2J\x1b[?25l")  # clear, hide cursor
        return True

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is None:
            self._emit("\x1b[?25h\x1b[0m\n")  # restore cursor
            return
        super().put_frame(frame, blocking)
        rgb = _tile_to_rgb(frame.data, frame.desc)
        sy, sx = (torch.as_tensor(a, device=rgb.device) for a in self._grid)
        small = rgb[sy[:, None], sx[None, :], :].cpu().numpy().astype(np.int32)  # [oh, ow, 3]
        top, bot = small[0::2], small[1::2]
        lines = ["\x1b[H"]
        for r in range(top.shape[0]):
            cells = []
            for c in range(top.shape[1]):
                tr, tg, tb = top[r, c]
                br, bg, bb = bot[r, c]
                cells.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
            lines.append("".join(cells) + "\x1b[0m\n")
        self._emit("".join(lines))

    def done(self) -> None:
        self._emit("\x1b[?25h\x1b[0m")
        if self._fh is not None:
            self._fh.close()


class PanoDisplay(VideoDisplay):
    """``pano[:fov=<deg>][:yaw=<deg>][:pitch=<deg>][:size=WxH][:out=<display>]``

    Treats the incoming frame as a 360°x180° equirectangular panorama and
    renders a rectilinear view (ref: src/video_display/pano_gl.cpp renders
    the same projection on a GL sphere).  The per-pixel source coordinates
    are computed at reconfigure; per frame the view is one gather on the
    frame's device.  ``set_view(yaw, pitch, fov)`` retargets the camera
    (rebuilds the grid).
    """

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.fov, self.yaw, self.pitch = 90.0, 0.0, 0.0
        self.ow, self.oh = 1280, 720
        child = "dummy"
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "fov":
                self.fov = float(val)
            elif key == "yaw":
                self.yaw = float(val)
            elif key == "pitch":
                self.pitch = float(val)
            elif key == "size":
                w, _, h = val.partition("x")
                self.ow, self.oh = int(w), int(h)
            elif key == "out":
                child = val.replace(";", ":")  # nested opts use ';'
        self.child = initialize_video_display(child, device=device)
        self._grid: Optional[tuple] = None

    def set_view(self, yaw: Optional[float] = None, pitch: Optional[float] = None,
                 fov: Optional[float] = None) -> None:
        if yaw is not None:
            self.yaw = yaw
        if pitch is not None:
            self.pitch = pitch
        if fov is not None:
            self.fov = fov
        if self.desc is not None:
            self._build_grid(self.desc)

    def _build_grid(self, desc: VideoDesc) -> None:
        w, h, ow, oh = desc.width, desc.height, self.ow, self.oh
        f = 0.5 * ow / np.tan(np.radians(self.fov) / 2)
        xs = (np.arange(ow) - ow / 2 + 0.5) / f
        ys = (np.arange(oh) - oh / 2 + 0.5) / f
        xg, yg = np.meshgrid(xs, ys)
        # camera ray, then yaw/pitch rotation
        d = np.stack([xg, yg, np.ones_like(xg)], axis=-1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        cp, sp = np.cos(np.radians(self.pitch)), np.sin(np.radians(self.pitch))
        cy, sy_ = np.cos(np.radians(self.yaw)), np.sin(np.radians(self.yaw))
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
        dy, dz = dy * cp - dz * sp, dy * sp + dz * cp
        dx, dz = dx * cy + dz * sy_, -dx * sy_ + dz * cy
        lon = np.arctan2(dx, dz)  # [-pi, pi]
        lat = np.arcsin(np.clip(dy, -1, 1))  # [-pi/2, pi/2]
        sx = ((lon / (2 * np.pi) + 0.5) * w).astype(np.int32) % w
        syr = np.clip(((lat / np.pi + 0.5) * h).astype(np.int32), 0, h - 1)
        self._grid = (sx, syr)

    def reconfigure(self, desc: VideoDesc) -> bool:
        super().reconfigure(desc)
        self._build_grid(desc)
        self.out_desc = VideoDesc(self.ow, self.oh, Codec.RGB, desc.fps)
        return self.child.reconfigure(self.out_desc)

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is None:
            self.child.put_frame(None)
            return
        super().put_frame(frame, blocking)
        rgb = _tile_to_rgb(frame.data, frame.desc)
        sx, sy = (torch.as_tensor(a, dtype=torch.int64, device=rgb.device) for a in self._grid)
        out = rgb[sy, sx, :].reshape(self.oh, self.ow * 3)
        self.child.put_frame(VideoFrame(self.out_desc, [out], timestamp=frame.timestamp), blocking)

    def done(self) -> None:
        self.child.done()


# in-process frame delegates for the pipe display, keyed by name
PIPE_DELEGATES: Dict[str, Callable[[Optional[VideoFrame]], None]] = {}


def register_pipe_delegate(key: str, fn: Callable[[Optional[VideoFrame]], None]) -> None:
    PIPE_DELEGATES[key] = fn


class PipeDisplay(VideoDisplay):
    """``pipe:<delegate-key>`` — frames go to an in-process callable
    registered via :func:`register_pipe_delegate` (ref:
    src/video_display/pipe.c's ``pipe_frame_recv_delegate``; the reference
    passes a pointer through the fmt string, here a registry key).  The
    delegate also receives the ``None`` poison pill on teardown.
    """

    retains_frames = True  # the delegate may keep the frame

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.key = cfg
        if cfg not in PIPE_DELEGATES:
            raise ValueError(f"pipe: no delegate registered under {cfg!r}")
        self.delegate = PIPE_DELEGATES[cfg]

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is not None:
            super().put_frame(frame, blocking)
        self.delegate(frame)


class AggregateDisplay(VideoDisplay):
    """``aggregate:disp1#disp2[#...]`` — tile *i* of a multi-tile frame goes
    to child display *i* (ref: src/video_display/aggregate.c).  Single-tile
    frames are replicated (matching the reference's 1-device behavior).
    """

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.children = [initialize_video_display(s, device=device) for s in cfg.split("#") if s]
        if not self.children:
            raise ValueError("aggregate: needs at least one child display")
        self.retains_frames = any(c.retains_frames for c in self.children)

    def get_property_codecs(self) -> List[Codec]:
        codecs = None
        for c in self.children:
            own = set(c.get_property_codecs())
            codecs = own if codecs is None else codecs & own
        return sorted(codecs or [], key=int)

    def reconfigure(self, desc: VideoDesc) -> bool:
        super().reconfigure(desc)
        tile_desc = desc.with_(tile_count=1)
        return all(c.reconfigure(tile_desc) for c in self.children)

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is None:
            for c in self.children:
                c.put_frame(None)
            return
        super().put_frame(frame, blocking)
        tiles = frame.tiles if len(frame.tiles) > 1 else frame.tiles * len(self.children)
        tile_desc = frame.desc.with_(tile_count=1)
        for c, t in zip(self.children, tiles):
            c.put_frame(VideoFrame(tile_desc, [t], timestamp=frame.timestamp), blocking)

    def done(self) -> None:
        for c in self.children:
            c.done()


class BlendDisplay(VideoDisplay):
    """``blend:<real display spec>`` — crossfades between senders on stream
    (SSRC) switch before forwarding to a real display (ref:
    src/video_display/blend.cpp — hd-rum-translator's transition effect;
    the reference also byte-lerps the raw frame data).  Frames carry their
    source in ``frame.callbacks['ssrc']``; a switch starts a
    TRANSITION_FRAMES-long linear crossfade from the last frame of the
    previous source, computed on the frames' device.
    """

    retains_frames = True  # holds put frames/views past put_frame

    TRANSITION_FRAMES = 10

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.child = initialize_video_display(cfg.replace(";", ":") or "dummy", device=device)
        self.cur_ssrc = None
        self.last_frame: Optional[torch.Tensor] = None
        self.fade_from: Optional[torch.Tensor] = None  # old source's final frame
        self.transition = 0

    def get_property_codecs(self) -> List[Codec]:
        return self.child.get_property_codecs()

    def reconfigure(self, desc: VideoDesc) -> bool:
        super().reconfigure(desc)
        return self.child.reconfigure(desc)

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is None:
            self.child.put_frame(None)
            return
        super().put_frame(frame, blocking)
        ssrc = frame.callbacks.get("ssrc", 0)
        data = frame.data
        if self.cur_ssrc is None:
            self.cur_ssrc = ssrc
        elif ssrc != self.cur_ssrc and self.last_frame is not None:
            self.cur_ssrc = ssrc
            self.fade_from = self.last_frame  # hold the old source's frame
            self.transition = self.TRANSITION_FRAMES
        if self.transition > 0 and self.fade_from is not None and self.fade_from.shape == data.shape:
            # the weights are Python doubles that numpy rounds to float32
            a = self.transition / (self.TRANSITION_FRAMES + 1)
            wa, wb = float(np.float32(a)), float(np.float32(1 - a))
            mixed = self.fade_from.to(torch.float32) * wa + data.to(torch.float32) * wb
            self.transition -= 1
            out = VideoFrame(frame.desc, [mixed.to(torch.uint8)], timestamp=frame.timestamp)
            self.child.put_frame(out, blocking)
        else:
            self.transition = 0
            self.fade_from = None
            self.child.put_frame(frame, blocking)
        self.last_frame = data

    def done(self) -> None:
        self.child.done()


register_module("caca", LibraryClass.VIDEO_DISPLAY, CacaDisplay)
register_module("blend", LibraryClass.VIDEO_DISPLAY, BlendDisplay)
register_module("pano", LibraryClass.VIDEO_DISPLAY, PanoDisplay)
register_module("pipe", LibraryClass.VIDEO_DISPLAY, PipeDisplay)
register_module("aggregate", LibraryClass.VIDEO_DISPLAY, AggregateDisplay)
