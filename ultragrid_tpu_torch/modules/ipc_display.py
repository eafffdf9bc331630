"""unix_sock / preview displays + the ipc_frame wire format.

The port of ``ultragrid_tpu/modules/ipc_display.py`` (ref:
src/video_display/unix_sock.cpp + tools/ipc_frame*.{h,cpp}): frames are
converted to RGB, optionally integer-downscaled so the pixel count lands
near ``target_size``, and streamed over a SOCK_STREAM unix socket as
[128-byte header | data] where the header is four little-endian int32s
(width, height, data_len, color_spec; RGB=11 — ipc_frame.h) padded with
zeros.  ``preview`` is the same display with preview defaults: socket
``<tmp>/ug_preview_disp_unix``, target 960x540, and a non-blocking putf
(ref: unix_sock.cpp:64-77,133-138).  The first 5 frames of a stream are
skipped like the reference (SKIP_FIRST_N_FRAMES_IN_STREAM).

The conversion to RGB and the downscale run on the frame's device (a frame
on the card stays there, in the stream that was current where it was put)
and the result crosses to the host once per frame, for the socket.  A host
frame is first copied to the display's device.
"""

from __future__ import annotations

import math
import os
import queue
import socket
import struct
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, stream_context
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_display import VideoDisplay
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.types import Codec, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("display.unix_sock")

IPC_FRAME_HEADER_LEN = 128
IPC_COLOR = {Codec.RGBA: 1, Codec.UYVY: 2, Codec.RGB: 11}
IPC_COLOR_REV = {v: k for k, v in IPC_COLOR.items()}
SKIP_FIRST_N = 5
DEFAULT_PREVIEW_NAME = "ug_preview_disp_unix"
DEFAULT_DISP_NAME = "ug_unix"
DEFAULT_SCALE = (960, 540)


def ipc_frame_write_header(width: int, height: int, data_len: int, color: int) -> bytes:
    return struct.pack("<iiii", width, height, data_len, color).ljust(IPC_FRAME_HEADER_LEN, b"\0")


def ipc_frame_parse_header(buf: bytes) -> Tuple[int, int, int, int]:
    return struct.unpack_from("<iiii", buf)


def ipc_scale_factor(src_w: int, src_h: int, target_w: int, target_h: int) -> int:
    """ref: ipc_frame_get_scale_factor, tools/ipc_frame_ug.cpp:233-244."""
    if target_w == -1 or target_h == -1:
        return 0
    scale = math.sqrt((src_w * src_h) / float(target_w * target_h))
    return int(round(max(scale, 1.0)))


class IpcFrameReader:
    """Accepting side of the ipc_frame unix socket (the role of the
    preview GUI / tools/ipc_frame consumers)."""

    def __init__(self, path: str):
        try:
            os.unlink(path)
        except OSError:
            pass
        self.path = path
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(path)
        self._srv.listen(1)
        self._conn: Optional[socket.socket] = None

    def accept(self, timeout: float = 10.0) -> None:
        self._srv.settimeout(timeout)
        self._conn, _ = self._srv.accept()

    def read_frame(self, timeout: float = 10.0):
        """Returns (width, height, color_spec Codec, data bytes) or None."""
        assert self._conn is not None
        self._conn.settimeout(timeout)
        hdr = b""
        while len(hdr) < IPC_FRAME_HEADER_LEN:
            chunk = self._conn.recv(IPC_FRAME_HEADER_LEN - len(hdr))
            if not chunk:
                return None
            hdr += chunk
        w, h, n, color = ipc_frame_parse_header(hdr)
        data = b""
        while len(data) < n:
            chunk = self._conn.recv(n - len(data))
            if not chunk:
                return None
            data += chunk
        return w, h, IPC_COLOR_REV.get(color, Codec.RGB), data

    def close(self) -> None:
        for s in (self._conn, self._srv):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        try:
            os.unlink(self.path)
        except OSError:
            pass


class UnixSockDisplay(VideoDisplay):
    """-d unix_socket[:path=<p>][:key=<k>][:target_size=<w>x<h>]"""

    retains_frames = True  # frames are queued to the sender worker thread
    is_preview = False

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        name = DEFAULT_PREVIEW_NAME if self.is_preview else DEFAULT_DISP_NAME
        path = os.path.join(tempfile.gettempdir(), name)
        self.target: Tuple[int, int] = DEFAULT_SCALE if self.is_preview else (-1, -1)
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "path":
                path = val
            elif key == "key":
                path += val
            elif key == "target_size":
                w, _, h = val.partition("x")
                self.target = (int(w), int(h))
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            self._sock.connect(path)  # raises if no consumer is listening
        except OSError:
            self._sock.close()
            raise
        self._skipped = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=5)
        self._worker = threading.Thread(target=self._run, name="unix-sock-disp", daemon=True)
        self._worker.start()
        log.notice(f"streaming ipc frames to {path}")

    def get_property_codecs(self) -> List[Codec]:
        return [Codec.RGB, Codec.RGBA, Codec.UYVY]

    def put_frame(self, frame: Optional[VideoFrame], blocking: bool = True) -> None:
        if frame is None:
            if self._worker.is_alive():
                try:
                    self._q.put(None, timeout=2.0)
                except queue.Full:
                    pass
            return
        super().put_frame(frame, blocking)
        if not self._worker.is_alive():
            return  # consumer went away; never wedge the pipeline
        # the worker converts in the stream current here, after the work
        # that made the frame
        data = frame.data
        item = (frame, torch.cuda.current_stream(data.device)
                if isinstance(data, torch.Tensor) and data.is_cuda else None)
        if self.is_preview or not blocking:
            try:
                self._q.put_nowait(item)
            except queue.Full:
                pass
        else:
            try:
                self._q.put(item, timeout=2.0)
            except queue.Full:
                pass

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            if self._skipped < SKIP_FIRST_N:
                self._skipped += 1
                continue
            frame, stream = item
            try:
                with stream_context(stream):
                    self._send(frame)
            except (BrokenPipeError, OSError):
                log.warning("ipc consumer went away")
                return

    def _send(self, frame: VideoFrame) -> None:
        desc = frame.desc
        data = frame.data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.ascontiguousarray(data), device=get_device(self.device))
        if desc.color_spec != Codec.RGB:
            data = pixfmt.convert_frame(data, desc.width, desc.color_spec, Codec.RGB)
        w, h = desc.width, desc.height
        rgb = data[:h, : 3 * w].reshape(h, w, 3)
        scale = ipc_scale_factor(w, h, *self.target)
        if scale > 1:
            rgb = rgb[::scale, ::scale]
            h, w = rgb.shape[0], rgb.shape[1]
        payload = rgb.contiguous().cpu().numpy().tobytes()  # the frame's one copy to the host
        self._sock.sendall(ipc_frame_write_header(w, h, len(payload), IPC_COLOR[Codec.RGB]) + payload)

    def done(self) -> None:
        if self._worker.is_alive():
            try:
                self._q.put(None, timeout=2.0)
            except queue.Full:
                pass
        self._worker.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass


class PreviewDisplay(UnixSockDisplay):
    """-d preview: unix_socket with preview defaults + non-blocking putf."""

    is_preview = True


register_module("unix_sock", LibraryClass.VIDEO_DISPLAY, UnixSockDisplay)
register_module("unix_socket", LibraryClass.VIDEO_DISPLAY, UnixSockDisplay)
register_module("preview", LibraryClass.VIDEO_DISPLAY, PreviewDisplay)
