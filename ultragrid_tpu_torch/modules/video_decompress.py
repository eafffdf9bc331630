"""Video decompression modules of the port: DXT, I420, JPEG, JPEG -> DXT and
the own H.264 decoder, on tensors.

Counterparts of ``VideoDecompress``, ``DxtDecompress``, ``I420Decompress``,
``JpegDecompress``, ``JpegToDxtDecompress`` and ``OwnH264Decompress`` in
``ultragrid_tpu/modules/video_decompress.py`` (reference lines 25-225; ref:
src/video_decompress.h:90-199), registered in the port's registry under the
reference's names (reference lines 228-238), and ``decompress_init``
(reference lines 423-443).  Each runs on ``device``, the card unless the
caller names another; the output frame's data is a uint8 tensor there.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, on_device
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.ops import dxt as dxt_ops
from ultragrid_tpu_torch.ops.h264_dec import StreamDecoder, UnsupportedStream
from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder
from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, decode_jpeg_to_frame
from ultragrid_tpu_torch.ops.planar import i420_8_to_uyvy
from ultragrid_tpu_torch.types import Codec, VideoFrame, get_codec_info
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.params import add_to_param, get_commandline_param

log = Logger("decompress")

add_to_param("h264-decoder",
             "H.264 decode path: own (default; the C entropy + reconstruction "
             "stage) | python (the Python decoder); lavc is not ported")


class VideoDecompress:
    #: (in_codec, out_codec) pairs this module supports
    SUPPORTS: List[Tuple[Codec, Codec]] = []

    def __init__(self, device="cuda"):
        self.device = get_device(device)

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        raise NotImplementedError

    def done(self) -> None:
        pass

    @staticmethod
    def _out(frame: VideoFrame, codec: Codec, data) -> VideoFrame:
        out = VideoFrame(frame.desc.with_(color_spec=codec), [data])
        out.timestamp = frame.timestamp
        return out


class DxtDecompress(VideoDecompress):
    """DXT1 / DXT5-YCoCg -> RGB (ref: src/video_decompress/dxt_glsl.c and
    the dxt_compress display shaders)."""

    SUPPORTS = [(Codec.DXT1, Codec.RGB), (Codec.DXT5, Codec.RGB)]

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        desc = frame.desc
        if out_codec != Codec.RGB:
            return None
        if desc.color_spec == Codec.DXT1:
            dec = dxt_ops.dxt1_decode_rgb
        elif desc.color_spec == Codec.DXT5:
            dec = dxt_ops.dxt5_ycocg_decode_rgb
        else:
            return None
        data = on_device(frame.data, self.device).reshape(-1)
        return self._out(frame, Codec.RGB, dec(data, desc.width, desc.height))


class I420Decompress(VideoDecompress):
    """I420 -> UYVY shim (ref: src/video_decompress/i420.c)."""

    SUPPORTS = [(Codec.I420, Codec.UYVY)]

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        if out_codec != Codec.UYVY:
            return None
        desc = frame.desc
        data = on_device(frame.data, self.device).reshape(-1)
        return self._out(frame, Codec.UYVY, i420_8_to_uyvy(data, desc.width, desc.height))


class JpegDecompress(VideoDecompress):
    """JPEG -> UYVY / RGB.  One decoder per module keeps the per-stream
    matrices of its session."""

    SUPPORTS = [(Codec.JPEG, Codec.UYVY), (Codec.JPEG, Codec.RGB)]

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.decoder = JpegDecoder(self.device)

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        return decode_jpeg_to_frame(frame, out_codec, self.decoder)


class JpegToDxtDecompress(JpegDecompress):
    """JPEG -> DXT1 / DXT5-YCoCg without leaving the device (ref:
    src/video_decompress/gpujpeg_to_dxt.cpp, for tiled display walls): the
    JPEG decode to RGB feeds the DXT block encoder."""

    SUPPORTS = [(Codec.JPEG, Codec.DXT1), (Codec.JPEG, Codec.DXT5)]

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        if out_codec not in (Codec.DXT1, Codec.DXT5):
            return None
        mid = decode_jpeg_to_frame(frame, Codec.RGB, self.decoder)
        if mid is None:
            return None
        enc = dxt_ops.dxt1_encode_rgb if out_codec == Codec.DXT1 else dxt_ops.dxt5_ycocg_encode_rgb
        return self._out(frame, out_codec, enc(mid.data, mid.desc.width))


class OwnH264Decompress(VideoDecompress):
    """The own H.264 decoder -> UYVY (ref: ``OwnH264Decompress``, reference
    lines 116-225): the C entropy and reconstruction stage
    (``native/h264_entropy.c`` through ``ops/h264_fast.py``) decodes
    progressive baseline/main/high CAVLC and CABAC I/P streams on the host;
    ``--param h264-decoder=python`` takes the Python decoder
    (``ops/h264_dec.py``).  Each decoded picture crosses to the module's
    device once, as I420 (1.5 bytes a pixel), and becomes UYVY there.

    The reference hands a stream outside the decoder's envelope
    (interlace, scaling lists, temporal direct) to libavcodec; the port has
    no libavcodec, so such a frame decodes to None with an error, which is
    what the reference does where libavcodec is absent.
    """

    SUPPORTS = [(Codec.H264, Codec.UYVY)]

    def __init__(self, device="cuda"):
        super().__init__(device)
        mode = get_commandline_param("h264-decoder")
        if mode == "lavc":
            raise NotImplementedError("--param h264-decoder=lavc needs libavcodec (ref "
                                      "ultragrid_tpu/modules/lavc.py), which is not ported")
        self._stream = None

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        if out_codec != Codec.UYVY:
            return None
        if self._stream is None:
            try:
                if get_commandline_param("h264-decoder") == "python":
                    raise UnsupportedStream("forced python decoder")
                self._stream = FastStreamDecoder()
            except UnsupportedStream:
                self._stream = StreamDecoder()
        data = frame.data
        au = bytes(data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data))
        try:
            got = self._stream.decode_au(au)
        except (UnsupportedStream, IndexError, KeyError) as exc:
            log.error(f"own H.264 decoder: stream out of envelope ({exc}); libavcodec, which "
                      "the reference hands it to, is not ported")
            return None
        if got is None:
            return None  # B-stream display reorder still priming
        y, cb, cr = got
        h, w = y.shape
        w2 = w // 2
        flat = np.concatenate([y.reshape(-1), np.ascontiguousarray(cb[:, :w2]).reshape(-1),
                               np.ascontiguousarray(cr[:, :w2]).reshape(-1)])
        uyvy = i420_8_to_uyvy(torch.from_numpy(flat).to(self.device), w, h)
        return VideoFrame(frame.desc.with_(width=w, height=h, color_spec=Codec.UYVY), [uyvy], frame.timestamp)


register_module("dxt", LibraryClass.VIDEO_DECOMPRESS, DxtDecompress)
register_module("h264_own", LibraryClass.VIDEO_DECOMPRESS, OwnH264Decompress)
register_module("i420", LibraryClass.VIDEO_DECOMPRESS, I420Decompress)
register_module("jpeg", LibraryClass.VIDEO_DECOMPRESS, JpegDecompress)
register_module("jpeg_to_dxt", LibraryClass.VIDEO_DECOMPRESS, JpegToDxtDecompress)


# the own H.264 decoder first, as the reference's probe order puts it
_ALL = [OwnH264Decompress, DxtDecompress, I420Decompress, JpegDecompress, JpegToDxtDecompress]

# streams only the reference's decoders read: the codec -> the reference
# module a port of it would need (ROADMAP queue 1)
_NOT_PORTED = {
    Codec.JPEG_XS: "jpegxs (ref JpegXsDecompress)",
    Codec.APV: "openapv (ref ApvDecompress)",
    Codec.CFHD: "cineform (ref CineformDecompress)",
    Codec.J2K: "cmpto_j2k (ref J2kDecompress)",
    Codec.J2KR: "cmpto_j2k (ref J2kDecompress)",
}


def decompress_init(in_codec: Codec, out_candidates: List[Codec], device="cuda"):
    """Pick a decompressor and its output codec (ref:
    src/video_decompress.c selection by priority): the first output
    candidate that a port module supports.  Returns (module on ``device``,
    out codec), or (None, None) when no candidate fits.  A stream that only
    a decoder outside the port reads is refused by name: nothing stands in
    for it."""
    for out_codec in out_candidates:
        for cls in _ALL:
            if (in_codec, out_codec) in cls.SUPPORTS:
                return cls(device), out_codec
    if get_codec_info(in_codec).opaque and not any(in_codec == c for cls in _ALL for c, _ in cls.SUPPORTS):
        need = _NOT_PORTED.get(in_codec, "libavcodec (ref LavcDecompress)")
        raise NotImplementedError(
            f"no decompressor for {in_codec.name} in the port: it needs {need}, "
            "which is not ported yet (ROADMAP queue 1)")
    return None, None
