"""Video display module API + built-in displays on tensors.

Port of ``ultragrid_tpu/modules/video_display.py``.  Mirrors the reference
display contract (ref: struct video_display_info,
src/video_display.h:153-199): the display owns the framebuffer; callers fetch
a frame slot with ``get_frame`` (allocated on the display's ``device``, the
card unless the caller names another) and hand it back with ``put_frame``.

Built-ins: dummy (stats only), null, dump (frames to files), file (raw
concatenated stream), conference (a grid composite on the frames' device).
Only the displays that write files fetch a frame to the host.
"""

from __future__ import annotations

import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device
from ultragrid_tpu_torch.modules.registry import LibraryClass, load_library, register_module
from ultragrid_tpu_torch.ops.postprocess import scale_nearest
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, get_codec_from_name, get_codec_info
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("display")


class VideoDisplay:
    # displays that hold a reference to a put frame (or a view of its data)
    # past put_frame's return set this; their frames are never pooled
    retains_frames = False

    def __init__(self, cfg: str, device="cuda"):
        self.cfg = cfg
        self.device = device  # resolved when a frame is allocated
        self.desc: Optional[VideoDesc] = None
        self.frames_shown = 0
        self._fps_t0 = time.monotonic()
        self._fps_count = 0
        self._pool: List[VideoFrame] = []

    def get_property_codecs(self) -> List[Codec]:
        """Codecs the display accepts natively (ref: DISPLAY_PROPERTY_CODECS)."""
        return [c for c in Codec if not get_codec_info(c).opaque and c != Codec.NONE]

    def reconfigure(self, desc: VideoDesc) -> bool:
        self.desc = desc
        self._pool.clear()
        return True

    def get_frame(self) -> VideoFrame:
        """Display-owned framebuffer on the display's device, recycled like
        the reference's video_frame_pool (ref: display_get_frame semantics,
        src/video_display.h:185; pool src/utils/video_frame_pool.h:49)."""
        if self.desc is None:
            raise RuntimeError("get_frame before reconfigure")
        while self._pool:
            f = self._pool.pop()
            if f.desc == self.desc:
                return f
        return VideoFrame.alloc(self.desc, get_device(self.device))

    def recycle(self, frame: Optional[VideoFrame]) -> None:
        """Return a frame whose presentation finished to the pool.  Callers
        (the receiver) invoke this after put_frame returns; no-op for
        displays that retain frames or for frames the pool cannot reuse."""
        if (self.retains_frames or frame is None or len(self._pool) >= 4
                or frame.desc != self.desc or len(frame.tiles) != 1):
            return
        if isinstance(frame.tiles[0], torch.Tensor):
            frame.callbacks.clear()
            self._pool.append(frame)

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        """None frame = poison pill/flush (ref: display_put_frame semantics)."""
        if frame is None:
            return
        self.frames_shown += 1
        self._fps_count += 1
        now = time.monotonic()
        if now - self._fps_t0 >= 5.0:
            fps = self._fps_count / (now - self._fps_t0)
            log.notice(f"{self.frames_shown} frames in {now - self._fps_t0:.2f} s ({fps:.2f} fps)")
            self._fps_t0 = now
            self._fps_count = 0

    def done(self) -> None:
        pass


class DummyDisplay(VideoDisplay):
    """Discards frames, reports stats (ref: src/video_display/dummy.c).

    Option ``codec=X`` restricts accepted codecs (for forcing conversions).
    """

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.forced_codec: Optional[Codec] = None
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "codec":
                self.forced_codec = get_codec_from_name(val)

    def get_property_codecs(self) -> List[Codec]:
        if self.forced_codec is not None:
            return [self.forced_codec]
        return super().get_property_codecs()


class NullDisplay(VideoDisplay):
    """Absolute no-op (ref: src/video_display/null.cpp)."""

    def put_frame(self, frame, blocking: bool = True) -> None:
        pass


def _host_bytes(data) -> np.ndarray:
    """A frame's bytes on the host, for a display that writes them out."""
    return data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data)


class DumpDisplay(VideoDisplay):
    """Writes each frame to a file (ref: src/video_display/dump.cpp)."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.dir = cfg or "dump"
        os.makedirs(self.dir, exist_ok=True)

    def put_frame(self, frame, blocking: bool = True) -> None:
        if frame is None:
            return
        super().put_frame(frame, blocking)
        ext = get_codec_info(frame.desc.color_spec).file_extension or "raw"
        path = os.path.join(self.dir, f"frame{self.frames_shown:06d}.{ext}")
        _host_bytes(frame.data).tofile(path)


class FileDisplay(VideoDisplay):
    """Appends raw frames to a single file (ref: src/video_display/file.cpp)."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.path = cfg or "out.raw"
        self._fh = open(self.path, "wb")

    def put_frame(self, frame, blocking: bool = True) -> None:
        if frame is None:
            return
        super().put_frame(frame, blocking)
        self._fh.write(_host_bytes(frame.data).tobytes())

    def done(self) -> None:
        self._fh.close()


class ConferenceDisplay(VideoDisplay):
    """Mix multiple senders into a tiled grid (ref: src/video_display/
    conference.cpp).  Config: ``conference:WxH[:cols]``; each participant
    (keyed by SSRC from frame.callbacks) is nearest-scaled into a grid cell
    of a UYVY composite on the frames' device, exposed as ``.composite``.
    """

    retains_frames = True  # holds put frames/views past put_frame

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        parts = [p for p in cfg.split(":") if p]
        size = parts[0] if parts else "1920x1080"
        w, _, h = size.partition("x")
        self.out_w, self.out_h = int(w), int(h)
        self.cols = int(parts[1]) if len(parts) > 1 else 0
        self.participants: dict = {}
        self.composite: Optional[torch.Tensor] = None

    def get_property_codecs(self) -> List[Codec]:
        return [Codec.UYVY]

    def put_frame(self, frame, blocking: bool = True) -> None:
        if frame is None:
            return
        super().put_frame(frame, blocking)
        self.participants[frame.callbacks.get("ssrc", 0)] = frame
        n = len(self.participants)
        cols = self.cols or max(1, math.ceil(math.sqrt(n)))
        rows = math.ceil(n / cols)
        cw = self.out_w // cols // 2 * 2
        ch = self.out_h // rows // 2 * 2
        # UYVY black background (u=128 y=16 v=128 y=16 byte pattern)
        group = torch.tensor([128, 16, 128, 16], dtype=torch.uint8, device=frame.data.device)
        comp = group.repeat(self.out_h, self.out_w // 2)
        for i, (_, f) in enumerate(sorted(self.participants.items())):
            y0 = (i // cols) * ch
            x0 = (i % cols) * cw * 2
            comp[y0 : y0 + ch, x0 : x0 + cw * 2] = scale_nearest(f.data, f.desc.width, Codec.UYVY, cw, ch)
        self.composite = comp


register_module("dummy", LibraryClass.VIDEO_DISPLAY, DummyDisplay)
register_module("null", LibraryClass.VIDEO_DISPLAY, NullDisplay)
register_module("dump", LibraryClass.VIDEO_DISPLAY, DumpDisplay)
register_module("file", LibraryClass.VIDEO_DISPLAY, FileDisplay)
register_module("conference", LibraryClass.VIDEO_DISPLAY, ConferenceDisplay)


def initialize_video_display(spec: str, device="cuda") -> VideoDisplay:
    """ref: initialize_video_display, src/video_display.c; the display
    allocates its frames on ``device``."""
    name, _, cfg = spec.partition(":")
    cls = load_library(name, LibraryClass.VIDEO_DISPLAY)
    if cls is None:
        raise ValueError(f"unknown display {name!r}")
    return cls(cfg, device=device)
