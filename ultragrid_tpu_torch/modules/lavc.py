"""libavcodec-backed video compress/decompress modules of the port.

Counterparts of ``LavcCompress`` and ``LavcDecompress`` in
``ultragrid_tpu/modules/lavc.py`` (ref: src/video_compress/libavcodec.cpp:
200-248, src/video_decompress/libavcodec.c), registered as ``libavcodec`` /
``lavc`` (compress) and ``libavcodec`` (decompress).  Both wrap the system
library through the port's copy of the shim (``csrc/lavc_shim.c``, loaded by
``native.lavc_shim_lib``), so no version-specific struct layout is touched
from Python.

The encoder reads a frame's bytes on the host (a frame on the card comes down
once, through the displays' download helper); the decoder uploads each
decoded frame once to the module's device.  The port's shim repairs the
reference's decoder fault F1 (frame threads, no drain): every packet gives
its frame as soon as the stream's reordering allows, and :meth:`LavcDecompress.flush`
returns the frames a B-frame stream still holds at its end.

Where the FFmpeg headers are absent, :func:`lavc_available` is false, as the
reference's is, and building either module raises an error that names
libavcodec.

Grammar (ref: libavcodec.cpp usage): ``libavcodec:codec=H.264[:bitrate=N]
[:encoder=libx264][:q=QP][:<lavc opt>=<val>...]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import numpy as np
import torch

from ultragrid_tpu_torch import native
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_compress import VideoCompress
from ultragrid_tpu_torch.modules.video_decompress import VideoDecompress
from ultragrid_tpu_torch.modules.video_display import _host_bytes
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, vc_get_linesize
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("lavc")

# UG codec -> preferred lavc encoder names (ref: codec_params[] in
# libavcodec.cpp — the reference prefers libx264/libx265/libvpx the same way)
ENCODERS: Dict[Codec, List[str]] = {
    Codec.H264: ["libx264", "libopenh264"],
    Codec.H265: ["libx265", "hevc_nvenc"],
    Codec.VP8: ["libvpx"],
    Codec.VP9: ["libvpx-vp9"],
    Codec.AV1: ["libaom-av1", "libsvtav1", "librav1e"],
    Codec.FFV1: ["ffv1"],
    Codec.PRORES: ["prores"],
    Codec.JPEG: ["mjpeg"],
    Codec.CFHD: ["cfhd"],
}
DECODERS: Dict[Codec, List[str]] = {
    Codec.H264: ["h264"],
    Codec.H265: ["hevc"],
    Codec.VP8: ["vp8"],
    Codec.VP9: ["vp9"],
    Codec.AV1: ["libdav1d", "libaom-av1", "av1"],
    Codec.FFV1: ["ffv1"],
    Codec.PRORES: ["prores"],
    Codec.JPEG: ["mjpeg"],
    Codec.CFHD: ["cfhd"],
}
CODEC_NAMES = {
    "H.264": Codec.H264, "H264": Codec.H264,
    "H.265": Codec.H265, "H265": Codec.H265, "HEVC": Codec.H265,
    "VP8": Codec.VP8, "VP9": Codec.VP9, "AV1": Codec.AV1,
    "FFV1": Codec.FFV1, "prores": Codec.PRORES, "MJPEG": Codec.JPEG,
    "JPEG": Codec.JPEG, "CFHD": Codec.CFHD, "cineform": Codec.CFHD,
}
_IN_FMT = {Codec.UYVY: 0, Codec.RGB: 1, Codec.YUYV: 3, Codec.RGBA: 4}
# low-latency defaults per encoder (the reference sets the same:
# zerolatency/realtime so no frame is buffered in lookahead)
_ENCODER_DEFAULTS = {
    "libx264": "tune=zerolatency",
    "libx265": "tune=zerolatency",
    "libvpx": "deadline=realtime:lag-in-frames=0",
    "libvpx-vp9": "deadline=realtime:lag-in-frames=0",
    "libaom-av1": "usage=realtime:lag-in-frames=0:cpu-used=8",
}


def lavc_available() -> bool:
    return native.lavc_headers_present()


def lavc_encoders() -> List[str]:
    """The names of the encoders libavcodec offers (ref ``lavc_encoders``,
    modules/lavc.py:70, over the shim's ``lavc_list``); ``[]`` where the
    shim does not load."""
    lib = native.lavc_shim_lib() if lavc_available() else None
    if lib is None:
        return []
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.lavc_list(1, buf, 1 << 16)
    return buf.raw[:n].decode().split()


def _lib() -> ctypes.CDLL:
    if not lavc_available():
        raise ValueError("libavcodec unavailable: no FFmpeg headers for the shim (csrc/lavc_shim.c)")
    return native.lavc_shim_lib()


class LavcCompress(VideoCompress):
    """``-c libavcodec:codec=H.264[:bitrate=][:encoder=][:opt=val...]``."""

    def __init__(self, cfg: str = "", device="cuda"):
        super().__init__(cfg, device)
        self.codec = Codec.H264
        self.encoder_name: Optional[str] = None
        self.bitrate = 0
        self.extra_opts: List[str] = []
        for part in (cfg or "").split(":"):
            if not part:
                continue
            key, _, val = part.partition("=")
            if key == "codec":
                c = CODEC_NAMES.get(val)
                if c is None:
                    raise ValueError(f"libavcodec: unknown codec {val!r}")
                self.codec = c
            elif key == "encoder":
                self.encoder_name = val
            elif key in ("bitrate", "b"):
                mult = 1
                if val and val[-1] in "kKmM":
                    mult = 1000 if val[-1] in "kK" else 1000000
                    val = val[:-1]
                self.bitrate = int(float(val) * mult)
            else:
                self.extra_opts.append(part)
        self._h = None
        self._desc: Optional[VideoDesc] = None
        self._pkt: Optional[np.ndarray] = None
        self._extradata: Optional[bytes] = None
        self._lib = _lib()

    def _open(self, desc: VideoDesc) -> bool:
        names = [self.encoder_name] if self.encoder_name else ENCODERS.get(self.codec, [])
        in_fmt = _IN_FMT.get(desc.color_spec)
        if in_fmt is None:
            return False
        opts = ":".join(self.extra_opts)
        if not self.bitrate:
            # sane default like the reference's rate control fallback
            self.bitrate = int(desc.width * desc.height * max(desc.fps, 1) * 0.1)
        for name in names:
            if not name or not self._lib.lavc_have(name.encode(), 1):
                continue
            eopts = opts
            defaults = _ENCODER_DEFAULTS.get(name)
            if defaults:
                eopts = f"{defaults}:{opts}" if opts else defaults
            h = self._lib.lavc_enc_open(name.encode(), desc.width, desc.height, in_fmt,
                                        int(desc.fps) or 30, self.bitrate, eopts.encode())
            if h:
                self._h = h
                ed = np.empty(4096, np.uint8)
                n = self._lib.lavc_enc_extradata(h, ed.ctypes.data, ed.size)
                self._extradata = bytes(ed[:n]) if n > 0 else None
                log.notice(f"libavcodec: encoder {name} {desc.width}x{desc.height} "
                           f"@{self.bitrate/1e6:.1f} Mbps")
                return True
        return False

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        desc = frame.desc
        if self._h is None or self._desc != desc:
            if self._h is not None:
                self._lib.lavc_enc_close(self._h)
                self._h = None
            if not self._open(desc):
                log.error(f"libavcodec: no encoder for {self.codec.name}")
                return None
            self._desc = desc
            cap = desc.width * desc.height * 4 + (1 << 16)
            self._pkt = np.empty(cap, np.uint8)
        data = np.ascontiguousarray(_host_bytes(frame.data))
        ls = data.shape[1] if data.ndim == 2 else vc_get_linesize(desc.width, desc.color_spec)
        key = ctypes.c_int(0)
        n = self._lib.lavc_enc_frame(self._h, data.ctypes.data, ls, 0, self._pkt.ctypes.data, self._pkt.size,
                                     ctypes.byref(key))
        if n <= 0:
            return None  # buffered (b-frames off, so only on errors)
        out = self._out(frame, self.codec, self._pkt[:n].copy())
        out.callbacks["keyframe"] = bool(key.value)
        if self._extradata:
            # FFV1-class codecs carry a configuration record out of band
            out.callbacks["extradata"] = self._extradata
        return out

    def done(self) -> None:
        if self._h is not None:
            self._lib.lavc_enc_close(self._h)
            self._h = None


class LavcDecompress(VideoDecompress):
    """Decoder side (ref: src/video_decompress/libavcodec.c)."""

    SUPPORTS = [(c, o) for c in DECODERS for o in (Codec.UYVY, Codec.RGB)]

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._h = None
        self._in: Optional[Codec] = None
        self._fps = 30.0
        self._out_buf: Optional[np.ndarray] = None
        self._lib = _lib()

    def _buffer(self, desc: VideoDesc) -> np.ndarray:
        cap = max(desc.width * desc.height, 16) * 4 + (1 << 16)
        if self._out_buf is None or self._out_buf.size < cap:
            self._out_buf = np.empty(cap, np.uint8)
        return self._out_buf

    def _frame(self, n: int, wh, out_codec: Codec) -> VideoFrame:
        w, h = wh[0], wh[1]
        bpp = 2 if out_codec == Codec.UYVY else 3
        data = torch.from_numpy(self._out_buf[:n].reshape(h, w * bpp)).to(self.device, copy=True)
        return VideoFrame(VideoDesc(w, h, out_codec, self._fps), [data])

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        desc = frame.desc
        if self._h is None or self._in != desc.color_spec:
            if self._h is not None:
                self._lib.lavc_dec_close(self._h)
                self._h = None
            ed = frame.callbacks.get("extradata")
            for name in DECODERS.get(desc.color_spec, []):
                if ed:
                    eda = np.frombuffer(ed, np.uint8)
                    h = self._lib.lavc_dec_open2(name.encode(), eda.ctypes.data, eda.size, desc.width, desc.height)
                else:
                    h = self._lib.lavc_dec_open2(name.encode(), None, 0, desc.width, desc.height)
                if h:
                    self._h = h
                    break
            if self._h is None:
                return None
            self._in = desc.color_spec
        self._fps = desc.fps
        data = np.ascontiguousarray(_host_bytes(frame.data).reshape(-1))
        buf = self._buffer(desc)
        wh = (ctypes.c_int * 2)()
        n = self._lib.lavc_dec_packet(self._h, data.ctypes.data, data.size, 0 if out_codec == Codec.UYVY else 1,
                                      buf.ctypes.data, buf.size, wh)
        if n <= 0:
            return None
        out = self._frame(n, wh, out_codec)
        out.timestamp = frame.timestamp
        return out

    def flush(self, out_codec: Codec) -> List[VideoFrame]:
        """The frames the decoder still holds at the end of a stream (a
        B-frame stream's reordering delay), in display order."""
        out: List[VideoFrame] = []
        if self._h is None:
            return out
        wh = (ctypes.c_int * 2)()
        while True:
            n = self._lib.lavc_dec_flush(self._h, 0 if out_codec == Codec.UYVY else 1, self._out_buf.ctypes.data,
                                         self._out_buf.size, wh)
            if n < 0:
                raise RuntimeError(f"libavcodec: draining the {self._in.name} decoder failed ({n})")
            if n == 0:
                return out
            out.append(self._frame(n, wh, out_codec))

    def done(self) -> None:
        if self._h is not None:
            self._lib.lavc_dec_close(self._h)
            self._h = None


register_module("libavcodec", LibraryClass.VIDEO_COMPRESS, LavcCompress)
register_module("lavc", LibraryClass.VIDEO_COMPRESS, LavcCompress)  # alias
register_module("libavcodec", LibraryClass.VIDEO_DECOMPRESS, LavcDecompress)
