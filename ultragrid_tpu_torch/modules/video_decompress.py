"""Video decompression modules of the port: DXT, I420, JPEG, JPEG -> DXT, the
own H.264 decoder, JPEG XS, APV, CineForm and JPEG 2000, on tensors.

Counterparts of ``VideoDecompress``, ``DxtDecompress``, ``I420Decompress``,
``JpegDecompress``, ``JpegToDxtDecompress``, ``OwnH264Decompress``,
``JpegXsDecompress``, ``ApvDecompress``, ``CineformDecompress`` and
``J2kDecompress`` in ``ultragrid_tpu/modules/video_decompress.py``
(reference lines 25-414; ref: src/video_decompress.h:90-199), registered in
the port's registry under the reference's names, and ``decompress_init``
(reference lines 423-443).  Each runs on ``device``, the card unless the
caller names another; the output frame's data is a uint8 tensor there.
Where libavcodec is present, ``modules/lavc.py``'s decoder comes last in the
probe order and takes the streams the own decoders leave out, as in the
reference.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch import native
from ultragrid_tpu_torch.device import get_device, on_device
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.ops import dxt as dxt_ops
from ultragrid_tpu_torch.ops.apv import ApvCodec
from ultragrid_tpu_torch.ops.cfhd_bitstream import cfhd_decode
from ultragrid_tpu_torch.ops.cineform import CineformCodec
from ultragrid_tpu_torch.ops.h264_dec import StreamDecoder, UnsupportedStream
from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder
from ultragrid_tpu_torch.ops.j2k import J2KDecoder
from ultragrid_tpu_torch.ops.j2k import UnsupportedStream as J2kUnsupported
from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, decode_jpeg_to_frame
from ultragrid_tpu_torch.ops.jpegxs import JpegXsCodec
from ultragrid_tpu_torch.ops.planar import i420_8_to_uyvy
from ultragrid_tpu_torch.parallel.mesh import mesh_from_param
from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedJpegDecoder
from ultragrid_tpu_torch.types import Codec, VideoFrame, get_codec_info
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.params import add_to_param, get_commandline_param

log = Logger("decompress")

DECODER_GOT_CODEC = 1  # probing result marker (ref: video_decompress.h:95)

add_to_param("h264-decoder",
             "H.264 decode path: own (default; C entropy+recon, lavc "
             "fallback out of envelope) | lavc | python")


def _lavc_decompress(device):
    """libavcodec's decoder on ``device``, or None where libavcodec is absent
    (modules/lavc.py imports this module, so it is imported here)."""
    from ultragrid_tpu_torch.modules.lavc import LavcDecompress

    return LavcDecompress(device) if native.lavc_headers_present() else None


def stream_bytes(data) -> bytes:
    """A compressed frame's data (an array or a tensor anywhere) as bytes."""
    return bytes(data.cpu().numpy().reshape(-1) if isinstance(data, torch.Tensor) else np.asarray(data, np.uint8)
                 .reshape(-1))


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
    matrices of its session.  With ``--param cuda-device`` naming several
    cards, the UYVY decode runs by row band, one a card, and the bands are
    gathered onto the module's device (``parallel/sharded_jpeg.py``
    ``ShardedJpegDecoder``)."""

    SUPPORTS = [(Codec.JPEG, Codec.UYVY), (Codec.JPEG, Codec.RGB)]

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.decoder = JpegDecoder(self.device)
        mesh = mesh_from_param(self.device)
        self.banded = None if mesh is None else ShardedJpegDecoder(mesh, self.device)

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        return decode_jpeg_to_frame(frame, out_codec, self.decoder, uyvy_decoder=self.banded)


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

    A stream outside the decoder's envelope (interlace, scaling lists,
    temporal direct) is handed to libavcodec for good, with the GOP so far
    replayed into it (reference lines 158-184); ``--param
    h264-decoder=lavc`` hands it over from the first frame.  Where
    libavcodec is absent such a frame decodes to None with an error, as in
    the reference.
    """

    SUPPORTS = [(Codec.H264, Codec.UYVY)]

    GOP_CACHE_CAP = 512  # AUs kept since the last IDR for the lavc takeover

    def __init__(self, device="cuda"):
        super().__init__(device)
        self._stream = None
        self._delegate = None  # lavc takes over after UnsupportedStream
        self._gop_cache: List[bytes] = []  # raw AUs since the last IDR

    @staticmethod
    def _has_idr(au: bytes) -> bool:
        """Whether an Annex B access unit holds an IDR slice (NAL type 5);
        emulation prevention keeps 00 00 01 out of NAL payloads."""
        i = au.find(b"\x00\x00\x01")
        while 0 <= i < len(au) - 3:
            if au[i + 3] & 0x1F == 5:
                return True
            i = au.find(b"\x00\x00\x01", i + 3)
        return False

    def _cache_au(self, au: bytes) -> None:
        if not native.lavc_headers_present():
            return  # no libavcodec to hand the GOP to
        if self._has_idr(au):
            self._gop_cache = []
        if len(self._gop_cache) < self.GOP_CACHE_CAP:
            self._gop_cache.append(au)

    def _lavc_takeover(self, frame: VideoFrame, out_codec: Codec, why) -> Optional[VideoFrame]:
        self._delegate = _lavc_decompress(self.device)
        if self._delegate is None:
            log.error(f"own H.264 decoder: stream out of envelope ({why}); libavcodec, which "
                      "takes such streams over, is absent")
            return None
        log.notice(f"own H.264 decoder: stream out of envelope ({why}); libavcodec takes over")
        # replay the GOP so far (SPS/PPS and the IDR the own decoder consumed)
        # so that lavc has the references; return the freshest output
        out = None
        for au in self._gop_cache:
            vf = VideoFrame(frame.desc, [np.frombuffer(au, np.uint8)], frame.timestamp)
            got = self._delegate.decompress(vf, out_codec)
            if got is not None:
                out = got
        self._gop_cache = []
        return out

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        if out_codec != Codec.UYVY:
            return None
        if self._delegate is not None:
            return self._delegate.decompress(frame, out_codec)
        au = stream_bytes(frame.data)
        if self._stream is None:
            if get_commandline_param("h264-decoder") == "lavc":
                self._gop_cache = [au]
                return self._lavc_takeover(frame, out_codec, "forced by --param")
            try:
                if get_commandline_param("h264-decoder") == "python":
                    raise UnsupportedStream("forced python decoder")
                self._stream = FastStreamDecoder()
            except UnsupportedStream:
                self._stream = StreamDecoder()
        self._cache_au(au)
        try:
            got = self._stream.decode_au(au)
        except (UnsupportedStream, IndexError, KeyError) as exc:
            return self._lavc_takeover(frame, out_codec, exc)
        if got is None:
            return None  # B-stream display reorder still priming
        y, cb, cr = got
        h, w = y.shape
        w2 = w // 2
        flat = np.concatenate([y.reshape(-1), np.ascontiguousarray(cb[:, :w2]).reshape(-1),
                               np.ascontiguousarray(cr[:, :w2]).reshape(-1)])
        uyvy = i420_8_to_uyvy(torch.from_numpy(flat).to(self.device), w, h)
        return VideoFrame(frame.desc.with_(width=w, height=h, color_spec=Codec.UYVY), [uyvy], frame.timestamp)


def uyvy_interleave(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Integer Y [H, W], Cb and Cr [H, ~W/2] -> a UYVY frame [H, 2W] uint8 on
    their device, each sample clipped to 0..255."""
    h, w = y.shape
    out = torch.empty((h, 2 * w), dtype=torch.uint8, device=y.device)
    out[:, 1::2] = y.clamp(0, 255)
    out[:, 0::4] = cb.clamp(0, 255)
    out[:, 2::4] = cr.clamp(0, 255)
    return out


def cfhd_uyvy(planes: List[np.ndarray], device) -> torch.Tensor:
    """The device stage of the CFHD decoder: its 10-bit Y, V and U host
    planes uploaded in one copy, rounded to 8 bits (an exact inverse of the
    encoder's << 2) and interleaved to UYVY on ``device``."""
    flat = torch.from_numpy(np.concatenate([p.reshape(-1) for p in planes]).astype(np.int32)).to(device)
    ends = np.cumsum([p.size for p in planes])
    y, v, u = ((flat[e - p.size:e].view(p.shape) + 2) >> 2 for p, e in zip(planes, ends))
    return uyvy_interleave(y, u, v)  # CFHD's channel order is Y, V, U


class JpegXsDecompress(VideoDecompress):
    """JPEG XS-architecture stream -> UYVY (ref role:
    src/video_decompress/jpegxs.cpp; see ops/jpegxs.py): the bands decoded
    on the host, the inverse DWT, clip and interleave on the module's
    device."""

    SUPPORTS = [(Codec.JPEG_XS, Codec.UYVY)]

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.codec = JpegXsCodec(device=self.device)

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        if out_codec != Codec.UYVY:
            return None
        y, cb, cr = self.codec.decode_planes(stream_bytes(frame.data))
        return self._out(frame, Codec.UYVY, uyvy_interleave(y, cb, cr))


class ApvDecompress(VideoDecompress):
    """APV-architecture stream -> UYVY (ref role:
    src/video_decompress/openapv.cpp over liboapv; see ops/apv.py).  The
    coded 10-bit planes are rounded back to 8 bits on the module's device; a
    4:4:4 stream's chroma is decimated, a 4:0:0 stream refused."""

    SUPPORTS = [(Codec.APV, Codec.UYVY)]

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.codec = ApvCodec(device=self.device)

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        if out_codec != Codec.UYVY:
            return None
        planes = self.codec.decode_planes(stream_bytes(frame.data))
        if len(planes) != 3:
            log.error("openapv: only 4:2:2/4:4:4 streams map to UYVY")
            return None
        y, cb, cr = ((p + 2) >> 2 for p in planes)  # 10 -> 8 bit
        if cb.shape[1] == y.shape[1]:  # 444 stream: decimate chroma
            cb, cr = cb[:, ::2], cr[:, ::2]
        return self._out(frame, Codec.UYVY, uyvy_interleave(y, cb, cr))


class CineformDecompress(VideoDecompress):
    """CineForm stream -> UYVY (ref role: src/video_decompress/cineform.cpp).
    Real CFHD samples decode through ``ops/cfhd_bitstream.py`` on the host
    (the planes go up in one copy; the 10 -> 8 bit rounding and the
    interleave run on the module's device); UCF1 through ``ops/cineform.py``
    (the inverse wavelet on the device).

    A stream that neither parses goes to libavcodec's cfhd decoder; where
    libavcodec is absent it decodes to None with an error, as in the
    reference."""

    SUPPORTS = [(Codec.CFHD, Codec.UYVY)]

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.codec = CineformCodec(device=self.device)
        self._lavc = None

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        if out_codec != Codec.UYVY:
            return None
        stream = stream_bytes(frame.data)
        if stream[:4] == b"UCF1":
            y, cb, cr = self.codec.decode_planes(stream)
            return self._out(frame, Codec.UYVY, uyvy_interleave(y, cb, cr))
        try:
            planes = cfhd_decode(stream, frame.desc.width, frame.desc.height)
        except (ValueError, IndexError, struct.error, UnboundLocalError) as exc:  # what a foreign stream raises
            planes, why = None, str(exc)
        else:
            why = "no complete Y, U and V channels"
        if planes is None:
            if self._lavc is None:
                self._lavc = _lavc_decompress(self.device)
            if self._lavc is None:
                log.error(f"cineform: a CFHD stream the own decoder cannot parse ({why}) and no libavcodec")
                return None
            log.notice(f"cineform: a CFHD stream the own decoder cannot parse ({why}); libavcodec takes it")
            return self._lavc.decompress(frame, out_codec)
        return self._out(frame, Codec.UYVY, cfhd_uyvy(planes, self.device))


class J2kDecompress(VideoDecompress):
    """JPEG 2000 -> RGB (ref role: src/video_decompress/cmpto_j2k.cpp): the
    own T.800 decoder (``ops/j2k.py``: Tier-2 in numpy, Tier-1 in
    ``native/j2k_t1.c``) on the host, the RGB frame uploaded to the module's
    device once.

    The reference hands a codestream outside the own profile, or one it
    cannot read, to OpenJPEG through Pillow; neither is ported, so such a
    frame decodes to None with an error."""

    SUPPORTS = [(Codec.J2KR, Codec.RGB), (Codec.J2K, Codec.RGB)]

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        if out_codec != Codec.RGB:
            return None
        try:
            comps = J2KDecoder().decode(stream_bytes(frame.data))
        except (J2kUnsupported, ValueError, IndexError, struct.error) as exc:  # outside the profile, or corrupt
            log.error(f"j2k: the own decoder cannot read this codestream ({exc}); OpenJPEG, which the reference "
                      "hands it to, is not ported")
            return None
        arr = comps[0] if len(comps) == 1 else np.stack(comps[:3], axis=-1)
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        h, w = arr.shape[:2]
        rgb = torch.from_numpy(np.ascontiguousarray(arr[:, :, :3]).reshape(h, w * 3)).to(self.device)
        return self._out(frame, Codec.RGB, rgb)


register_module("dxt", LibraryClass.VIDEO_DECOMPRESS, DxtDecompress)
register_module("h264_own", LibraryClass.VIDEO_DECOMPRESS, OwnH264Decompress)
register_module("i420", LibraryClass.VIDEO_DECOMPRESS, I420Decompress)
register_module("jpeg", LibraryClass.VIDEO_DECOMPRESS, JpegDecompress)
register_module("jpeg_to_dxt", LibraryClass.VIDEO_DECOMPRESS, JpegToDxtDecompress)
register_module("jpegxs", LibraryClass.VIDEO_DECOMPRESS, JpegXsDecompress)
register_module("openapv", LibraryClass.VIDEO_DECOMPRESS, ApvDecompress)
register_module("cineform", LibraryClass.VIDEO_DECOMPRESS, CineformDecompress)
register_module("cmpto_j2k", LibraryClass.VIDEO_DECOMPRESS, J2kDecompress)


# the reference's probe order, the own H.264 decoder first
_ALL = [OwnH264Decompress, DxtDecompress, I420Decompress, JpegDecompress, JpegToDxtDecompress,
        JpegXsDecompress, ApvDecompress, CineformDecompress, J2kDecompress]


def decompress_init(in_codec: Codec, out_candidates: List[Codec], device="cuda"):
    """Pick a decompressor and its output codec (ref:
    src/video_decompress.c selection by priority): the first output
    candidate that a module supports, libavcodec's decoder last in the probe
    order where it is present.  Returns (module on ``device``, out codec),
    or (None, None) when no candidate fits.  A stream that only libavcodec
    reads is refused by name where libavcodec is absent: nothing stands in
    for it."""
    from ultragrid_tpu_torch.modules.lavc import LavcDecompress, lavc_available

    classes = _ALL + [LavcDecompress] if lavc_available() else _ALL
    for out_codec in out_candidates:
        for cls in classes:
            if (in_codec, out_codec) in cls.SUPPORTS:
                return cls(device), out_codec
    if (not lavc_available() and get_codec_info(in_codec).opaque
            and not any(in_codec == c for cls in _ALL for c, _ in cls.SUPPORTS)):
        raise NotImplementedError(f"no decompressor for {in_codec.name}: it needs libavcodec (LavcDecompress), "
                                  "whose FFmpeg headers are absent")
    return None, None
