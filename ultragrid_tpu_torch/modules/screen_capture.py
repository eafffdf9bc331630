"""X11 screen capture (``-t screen``), speaking the wire protocol directly.

Mirrors the reference's screen_x11 module (ref:
src/video_capture/screen_x11.c): a grab thread pulls ``GetImage`` ZPixmap
frames of the configured viewport into a bounded queue (QUEUE_SIZE_MAX = 3,
screen_x11.c:79) while the boss thread converts + hands frames to the
pipeline; the XFIXES cursor image is composited over the raw grab
(screen_x11.c:186-207).  Output is RGB like the reference
(``s->frame->color_spec = RGB``, screen_x11.c:165).

Grammar (screen_x11.c:85-92)::

    -t screen[:fps=<fps>][:display=<d>][:geometry=WxH[+x[+y]]|:size=WxH]

The port of ``ultragrid_tpu/modules/screen_capture.py``.  The grab, the
ZPixmap -> RGB conversion and the cursor composite stay host numpy, as in the
reference, so the bytes are the same; each frame is then uploaded once to the
capture's device (the card unless the caller names another), as the file
capture does.  The module speaks X11 through :mod:`ultragrid_tpu_torch.net.x11`
(pure sockets); a display name containing ``/`` is an explicit unix-socket
path (used by the tests' mock server).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_capture import VideoCapture
from ultragrid_tpu_torch.net.x11 import X11Connection, X11Error
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("screen")

QUEUE_SIZE_MAX = 3  # ref screen_x11.c:79


def _parse_geometry(val: str) -> Tuple[int, int, int, int]:
    """"WxH[+x[+y]]" -> (w, h, x, y)."""
    w_s, _, rest = val.partition("x")
    parts = rest.split("+")
    h = int(parts[0])
    x = int(parts[1]) if len(parts) > 1 else 0
    y = int(parts[2]) if len(parts) > 2 else 0
    return int(w_s), h, x, y


def zpixmap_to_rgb(raw: bytes, w: int, h: int, bpp: int, byte_order: int) -> np.ndarray:
    """ZPixmap bytes -> [h, w*3] RGB uint8.

    depth-24/32 LSB-first pixels sit in memory as B,G,R,X (the reference
    picks vc_copylineBGRAtoRGB for this case, screen_x11.c:260-268); MSB
    first is X,R,G,B (vc_copylineRGBAtoRGB path).
    """
    if bpp == 32:
        a = np.frombuffer(raw, np.uint8, count=w * h * 4).reshape(h, w, 4)
        rgb = a[:, :, 2::-1] if byte_order == 0 else a[:, :, 1:4]
    elif bpp == 24:
        stride = (w * 3 + 3) & ~3
        a = np.frombuffer(raw, np.uint8, count=stride * h).reshape(h, stride)[:, : w * 3]
        a = a.reshape(h, w, 3)
        rgb = a[:, :, ::-1] if byte_order == 0 else a
    elif bpp == 16:  # RGB565
        a = np.frombuffer(raw, "<u2" if byte_order == 0 else ">u2", count=w * h).reshape(h, w)
        a = a.astype(np.uint32)
        r = ((a >> 11) & 0x1F) * 255 // 31
        g = ((a >> 5) & 0x3F) * 255 // 63
        b = (a & 0x1F) * 255 // 31
        rgb = np.stack([r, g, b], axis=-1).astype(np.uint8)
    else:
        raise X11Error(f"unsupported ZPixmap bpp {bpp}")
    return np.ascontiguousarray(rgb).reshape(h, w * 3)


def composite_cursor(rgb: np.ndarray, cur, vx: int, vy: int, w: int, h: int) -> None:
    """Alpha-blend an XFIXES ARGB (premultiplied) cursor into an RGB frame
    in place (ref screen_x11.c:186-207 does the same copy loop)."""
    cx, cy, cw, ch, xhot, yhot, argb = cur
    img = np.frombuffer(argb, "<u4", count=cw * ch).reshape(ch, cw)
    x0 = cx - xhot - vx
    y0 = cy - yhot - vy
    sx0, sy0 = max(0, -x0), max(0, -y0)
    dx0, dy0 = max(0, x0), max(0, y0)
    cw_eff = min(cw - sx0, w - dx0)
    ch_eff = min(ch - sy0, h - dy0)
    if cw_eff <= 0 or ch_eff <= 0:
        return
    sub = img[sy0 : sy0 + ch_eff, sx0 : sx0 + cw_eff]
    a = (sub >> 24).astype(np.uint16)
    src = np.stack([(sub >> 16) & 0xFF, (sub >> 8) & 0xFF, sub & 0xFF], axis=-1).astype(np.uint16)
    view = rgb.reshape(rgb.shape[0], -1, 3)[dy0 : dy0 + ch_eff, dx0 : dx0 + cw_eff]
    # premultiplied source: dst = src + dst*(255-a)/255
    view[:] = np.minimum(src + view.astype(np.uint16) * (255 - a[..., None]) // 255, 255).astype(np.uint8)


class ScreenCapture(VideoCapture):
    """Grab-thread + bounded-queue screen capture over the X11 wire client."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        if cfg.strip() in ("help", ":help"):
            print("Screen capture\n\t-t screen[:fps=<fps>][:display=<d>]"
                  "[:geometry=WxH[+x[+y]]|:size=WxH]")
            raise SystemExit(0)
        fps = 0.0
        display: Optional[str] = None
        geom: Optional[Tuple[int, int, int, int]] = None
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "fps":
                fps = float(val)
            elif key == "display":
                display = val
            elif key in ("geometry", "size"):
                geom = _parse_geometry(val)
            else:
                log.warning(f"screen: unknown option {key}")

        self.conn = X11Connection(display)
        _, _, scr_w, scr_h, _ = (0, 0, self.conn.screen["width"], self.conn.screen["height"], 0)
        if geom:
            gw, gh, gx, gy = geom
            self.w = min(gw, scr_w)
            self.h = min(gh, scr_h)
            self.x = min(gx, scr_w - self.w)
            self.y = min(gy, scr_h - self.h)
        else:
            self.w, self.h, self.x, self.y = scr_w, scr_h, 0, 0
        self.fps = fps
        self.desc = VideoDesc(self.w, self.h, Codec.RGB, fps if fps > 0 else 30.0)
        self._queue: queue.Queue = queue.Queue(maxsize=QUEUE_SIZE_MAX)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._grab_thread, daemon=True, name="screen-grab")
        self._worker.start()
        log.info(f"screen capture {self.w}x{self.h}+{self.x}+{self.y} on root "
                 f"0x{self.conn.root:x}" + (f" @{fps} fps" if fps else ""))

    # -- worker ---------------------------------------------------------

    def _grab_thread(self) -> None:
        period = 1.0 / self.fps if self.fps > 0 else 0.0
        next_t = time.monotonic()
        while not self._stop.is_set():
            try:
                cur = self.conn.get_cursor_image()
                depth, bpp, raw, _vis = self.conn.get_image(self.x, self.y, self.w, self.h)
                rgb = zpixmap_to_rgb(raw, self.w, self.h, bpp, self.conn.image_byte_order)
                if cur is not None:
                    rgb = rgb.copy()
                    composite_cursor(rgb, cur, self.x, self.y, self.w, self.h)
            except (X11Error, OSError) as e:
                if not self._stop.is_set():
                    log.error(f"screen grab failed: {e}")
                    self._queue.put(None)  # wake the boss with EOS
                return
            try:
                self._queue.put(rgb, timeout=0.5)
            except queue.Full:  # boss stalled; drop the oldest grab
                try:
                    self._queue.get_nowait()
                    self._queue.put_nowait(rgb)
                except (queue.Empty, queue.Full):
                    pass
            if period:
                next_t += period
                delay = next_t - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    next_t = time.monotonic()

    # -- boss API -------------------------------------------------------

    def grab(self):
        try:
            rgb = self._queue.get(timeout=2.0)
        except queue.Empty:
            return None, None
        if rgb is None:
            return None, None
        if not rgb.flags.writeable:  # a view of the reply's bytes
            rgb = rgb.copy()
        frame = VideoFrame(self.desc, [torch.from_numpy(rgb).to(self.device)])
        frame.timestamp = time.monotonic()
        return frame, None

    def done(self) -> None:
        self._stop.set()
        self.conn.close()
        self._worker.join(timeout=2.0)


register_module("screen", LibraryClass.VIDEO_CAPTURE, ScreenCapture)
