"""MPEG-TS rxtx: H.264 inside an MPEG transport stream over UDP
(ref: src/rxtx/mpegts.c — the reference drives libavformat's mpegts muxer
the same way; any TS receiver — VLC, ffplay, a set-top box — can play the
output).

Sender: capture -> H.264 (libavcodec) -> mpegts mux -> udp://host:port.
Receiver: libavformat demux+decode from udp://@:port -> display (reuses the
lavf path of the file capture device).

The port of ``ultragrid_tpu/pipeline/mpegts.py``: the capture and its
filters run on the session's device (the card unless the caller names
another); the encoder reads each frame's bytes on the host, and each decoded
frame is uploaded once to the display's device.  Without libavcodec both
ends raise an error that names it.
"""

from __future__ import annotations

import ctypes
import time
from typing import Optional

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, pipeline_stream, stream_context
from ultragrid_tpu_torch.modules.filters import FilterChain
from ultragrid_tpu_torch.modules.lavc import LavcCompress, lavc_available
from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
from ultragrid_tpu_torch.modules.video_display import initialize_video_display
from ultragrid_tpu_torch.native import lavc_shim_lib
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("mpegts")


class MpegTsSender:
    def __init__(
        self,
        capture_spec: str,
        host: str,
        port: int = 5004,
        bitrate: str = "8M",
        frame_limit: Optional[int] = None,
        capture_filter: str = "",
        device="cuda",
    ):
        if not lavc_available():
            raise ValueError("mpegts needs libavformat (libavcodec's FFmpeg headers are absent)")
        self.lib = lavc_shim_lib()
        self.device = get_device(device)
        self.stream = pipeline_stream(self.device)
        self.capture = initialize_video_capture(capture_spec, device=self.device)
        self.capture_chain = FilterChain(capture_filter)
        self.enc = LavcCompress(f"codec=H.264:bitrate={bitrate}", device=self.device)
        self.url = f"udp://{host}:{port}?pkt_size=1316"
        self.frame_limit = frame_limit
        self._mux = None
        self.frames_sent = 0

    def run(self) -> int:
        with stream_context(self.stream):
            return self._run()

    def _run(self) -> int:
        count = 0
        while self.frame_limit is None or count < self.frame_limit:
            frame, _a = self.capture.grab()
            if frame is not None:
                frame = self.capture_chain.apply(frame)
            if frame is None:
                continue
            out = self.enc.compress(frame)
            if out is None:
                continue
            data = np.ascontiguousarray(np.asarray(out.data).reshape(-1))
            if self._mux is None:
                d = frame.desc
                self._mux = self.lib.lavf_mux_open(
                    self.url.encode(), 0, d.width, d.height, int(d.fps) or 30,
                    None, 0,
                )
                if not self._mux:
                    raise RuntimeError(f"cannot open {self.url}")
                log.notice(f"mpegts: muxing H.264 to {self.url}")
            self.lib.lavf_mux_write(
                self._mux, data.ctypes.data, data.size,
                1 if out.callbacks.get("keyframe") else 0,
            )
            count += 1
            self.frames_sent += 1
        if self._mux:
            self.lib.lavf_mux_close(self._mux)
            self._mux = None
        self.capture.done()
        self.enc.done()
        return self.frames_sent


class MpegTsReceiver:
    def __init__(
        self,
        display_spec: str,
        port: int = 5004,
        frame_limit: Optional[int] = None,
        timeout: float = 30.0,
        device="cuda",
    ):
        if not lavc_available():
            raise ValueError("mpegts needs libavformat (libavcodec's FFmpeg headers are absent)")
        self.lib = lavc_shim_lib()
        self.device = get_device(device)
        self.display = initialize_video_display(display_spec, device=self.device)
        self.url = f"udp://0.0.0.0:{port}?timeout={int(timeout * 1e6)}"
        self.frame_limit = frame_limit
        self.timeout = timeout
        self.frames_displayed = 0

    def run(self) -> int:
        h = self.lib.lavf_open(self.url.encode())
        if not h:
            log.error(f"mpegts: cannot open {self.url}")
            return 0
        w = ctypes.c_int()
        hh = ctypes.c_int()
        fps = ctypes.c_double()
        self.lib.lavf_info(h, ctypes.byref(w), ctypes.byref(hh), ctypes.byref(fps))
        desc = VideoDesc(w.value, hh.value, Codec.UYVY, fps.value or 30.0)
        self.display.reconfigure(desc)
        buf = np.empty(w.value * hh.value * 2, np.uint8)
        start = time.monotonic()
        while self.frame_limit is None or self.frames_displayed < self.frame_limit:
            if time.monotonic() - start > self.timeout:
                break
            n = self.lib.lavf_read_frame(h, 0, buf.ctypes.data, buf.size)
            if n <= 0:
                break
            data = torch.from_numpy(buf[:n].reshape(hh.value, w.value * 2)).to(self.device, copy=True)
            frame = VideoFrame(desc, [data])
            self.display.put_frame(frame)
            self.frames_displayed += 1
        self.lib.lavf_close(h)
        self.display.put_frame(None)
        return self.frames_displayed
