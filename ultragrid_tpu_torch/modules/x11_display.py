"""X11 windowed display via the wire-protocol client (no Xlib/SDL/GL).

The port of ``ultragrid_tpu/modules/x11_display.py`` (ref:
src/video_display/sdl3.cpp, src/video_display/gl.cpp present frames in a
desktop window; a plain X11 core-protocol ``PutImage`` to a window needs
none of their libraries).  The display speaks the wire through the port's
:class:`ultragrid_tpu_torch.net.x11.X11Connection`, the client the ``-t
screen`` capture uses.

Accepts RGB/RGBA natively; the pipeline's decoder negotiates the conversion
from anything else (ref: ``DISPLAY_PROPERTY_CODECS``).  A frame is laid out
as the server's 32 bpp ZPixmap (BGRX LSB-first, XRGB MSB-first) on its own
device and comes to the host once, through the displays' download helper;
``put_image`` row-chunks it under the max-request-length.

Config: ``x11[:display=<DISPLAY>][:title=<str>]``; ``--window-title`` sets
the default title (ref: OPT_WINDOW_TITLE).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_display import VideoDisplay, _host_bytes
from ultragrid_tpu_torch.net.x11 import X11Connection, X11Error
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.params import get_commandline_param

log = Logger("x11")


def rgb_to_zpixmap(rgb: torch.Tensor, byte_order: int) -> bytes:
    """[h, w, 3] RGB -> 32 bpp ZPixmap bytes (BGRX LSB-first / XRGB MSB),
    laid out on ``rgb``'s device."""
    h, w, _ = rgb.shape
    px = torch.zeros((h, w, 4), dtype=torch.uint8, device=rgb.device)
    if byte_order == 0:  # LSB-first: memory B,G,R,X
        px[:, :, :3] = rgb.flip(2)
    else:  # MSB-first: memory X,R,G,B
        px[:, :, 1:] = rgb
    return _host_bytes(px).tobytes()


def frame_rgb(frame: VideoFrame) -> Optional[torch.Tensor]:
    """An RGB or RGBA frame's pixels as an [h, w, 3] view on its device;
    None for another codec."""
    desc = frame.desc
    data = frame.data
    if desc.color_spec == Codec.RGB:
        return data[:, : 3 * desc.width].reshape(desc.height, desc.width, 3)
    if desc.color_spec == Codec.RGBA:
        return data[:, : 4 * desc.width].reshape(desc.height, desc.width, 4)[:, :, :3]
    return None


class X11Display(VideoDisplay):
    """Present frames in an X11 window (``-d x11``)."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.display_name: Optional[str] = None
        self.title = get_commandline_param("window-title") or "ultragrid_tpu"
        for tok in filter(None, cfg.split(":")):
            if tok.startswith("display="):
                self.display_name = tok[8:]
            elif tok.startswith("title="):
                self.title = tok[6:]
        self.conn = X11Connection(self.display_name)
        self.win: Optional[int] = None
        self.gc: Optional[int] = None

    def get_property_codecs(self) -> List[Codec]:
        return [Codec.RGB, Codec.RGBA]

    def reconfigure(self, desc: VideoDesc) -> bool:
        if self.win is not None and self.desc is not None and (
                desc.width != self.desc.width or desc.height != self.desc.height):
            self.conn.destroy_window(self.win)
            self.win = None
        self.desc = desc
        if self.win is None:
            self.win = self.conn.create_window(desc.width, desc.height, self.title)
            self.gc = self.conn.create_gc(self.win)
            self.conn.sync()
            log.notice(f"[x11] window {desc.width}x{desc.height} mapped")
        return True

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is None or self.win is None:
            return
        desc = frame.desc
        rgb = frame_rgb(frame)
        if rgb is None:  # the negotiated codecs should prevent this
            log.error(f"x11: cannot present {desc.color_spec.name}")
            return
        self.conn.put_image(self.win, self.gc, 0, 0, desc.width, desc.height,
                            rgb_to_zpixmap(torch.as_tensor(rgb), self.conn.image_byte_order))
        self.conn.sync()
        super().put_frame(frame, blocking)

    def done(self) -> None:
        try:
            if self.win is not None:
                self.conn.destroy_window(self.win)
                self.conn.sync()
        except (OSError, X11Error):  # the server may already be gone
            pass
        self.conn.close()


register_module("x11", LibraryClass.VIDEO_DISPLAY, X11Display)
