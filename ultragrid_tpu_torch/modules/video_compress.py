"""Video compression modules of the port, and the compress driver.

Counterparts of ``NoneCompress``, ``UyvyCompress``, ``DxtCompress``,
``JpegCompress``, ``H264Compress``, ``JpegXsCompress``,
``CineformCompress``, ``J2kCompress`` and ``ApvCompress`` in
``ultragrid_tpu/modules/video_compress.py`` (reference lines 49-566),
registered in the port's registry under the reference's names (reference
lines 568-580), and of ``compress_init`` and ``CompressDriver``
(reference lines 583-679).  Each module runs on ``device``, the card unless
the caller names another: an array frame is copied there, a tensor frame
must already be there.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, on_device, stream_context
from ultragrid_tpu_torch.modules.messaging import (
    Message,
    MsgChangeCompress,
    Module,
    RESPONSE_INT_SERV_ERR,
    RESPONSE_OK,
    Response,
)
from ultragrid_tpu_torch.modules.registry import LibraryClass, list_modules, load_library, register_module
from ultragrid_tpu_torch.net.rtp_types import video_rtp_ts
from ultragrid_tpu_torch.ops import dxt as dxt_ops
from ultragrid_tpu_torch.ops import h264 as h264_ops
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.ops.apv import ApvCodec
from ultragrid_tpu_torch.ops.cfhd_bitstream import CfhdEncoder
from ultragrid_tpu_torch.ops.cineform import CineformCodec
from ultragrid_tpu_torch.ops.h264_dec import IntraDecoder, UnsupportedStream
from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice, Intra16EncoderDevice
from ultragrid_tpu_torch.ops.h264_transcode import Transcoder, _handle
from ultragrid_tpu_torch.ops.j2k import J2KEncoder
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
from ultragrid_tpu_torch.ops.jpegxs import JpegXsCodec
from ultragrid_tpu_torch.parallel.mesh import mesh_from_param
from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedJpegEncoder
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils import profiler
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.ratectl import GopRateController, h264_intra_controller, jpeg_controller, parse_rate

log = Logger("compress")


class VideoCompress:
    def __init__(self, cfg: str = "", device="cuda"):
        self.cfg = cfg
        self.device = get_device(device)

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        raise NotImplementedError

    def done(self) -> None:
        pass

    def _out(self, frame: VideoFrame, codec: Codec, data) -> VideoFrame:
        out = VideoFrame(frame.desc.with_(color_spec=codec), [data])
        out.timestamp = frame.timestamp
        return out


class NoneCompress(VideoCompress):
    """Passthrough (ref: src/video_compress/none.cpp)."""

    def compress(self, frame: VideoFrame) -> VideoFrame:
        return frame


class UyvyCompress(VideoCompress):
    """Downconvert to UYVY via the conversion registry (ref:
    src/video_compress/uyvy.cpp); None where no conversion exists."""

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        src = frame.desc.color_spec
        if src == Codec.UYVY:
            return frame
        if pixfmt.get_decoder_from_to(src, Codec.UYVY) is None:
            return None
        data = pixfmt.convert_frame(on_device(frame.data, self.device), frame.desc.width, src, Codec.UYVY)
        return self._out(frame, Codec.UYVY, data)


class DxtCompress(VideoCompress):
    """DXT1 / DXT5-YCoCg block compression (ref:
    src/video_compress/cuda_dxt.cpp + the cuda_dxt kernels).

    Config ``dxt[:DXT1|DXT5]`` (default DXT1; "DXT6"/"DXT5" = DXT5-YCoCg).
    Takes UYVY (with the reference's YUV->RGB pre-pass), RGB, RGBA, or any
    codec the registry converts to RGB; None for dimensions that are not
    multiples of 4 or a codec without a conversion.
    """

    def __init__(self, cfg: str = "", device="cuda"):
        super().__init__(cfg, device)
        kind = (cfg or "DXT1").upper().strip(":")
        if kind in ("", "DXT1"):
            self.out_codec = Codec.DXT1
        elif kind in ("DXT5", "DXT6", "DXT5_YCOCG"):
            self.out_codec = Codec.DXT5
        else:
            raise ValueError(f"dxt: unknown variant {cfg!r}")

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        desc = frame.desc
        if desc.width % 4 or desc.height % 4:
            return None
        src = desc.color_spec
        data = on_device(frame.data, self.device)
        if src != Codec.UYVY and src != Codec.RGB:
            if pixfmt.get_decoder_from_to(src, Codec.RGB) is None:
                return None
            data = pixfmt.convert_frame(data, desc.width, src, Codec.RGB)
            src = Codec.RGB
        if self.out_codec == Codec.DXT1:
            enc = dxt_ops.dxt1_encode_uyvy if src == Codec.UYVY else dxt_ops.dxt1_encode_rgb
        else:
            enc = dxt_ops.dxt5_ycocg_encode_uyvy if src == Codec.UYVY else dxt_ops.dxt5_ycocg_encode_rgb
        return self._out(frame, self.out_codec, enc(data, desc.width))


class JpegCompress(VideoCompress):
    """Config ``jpeg[:quality][:restart_interval][:subsampling][:rate=<bps>]``
    (quality default 80; subsampling 422 for YCbCr inputs, 444 for RGB, or
    420).  ``rate=`` (or a fixed ``-l`` on the sender, through
    :meth:`set_target_bitrate`) turns on closed-loop rate control: the
    quality ladder of :mod:`ultragrid_tpu_torch.utils.ratectl` follows the
    measured file sizes, one encoder per quality.

    With ``--param cuda-device`` naming several cards (the CLI's
    ``--cuda-device``), each frame is encoded by row band, one band a card
    (``parallel/sharded_jpeg.py`` ``ShardedJpegEncoder``); the file is the
    one-card file at the bands' restart interval, byte for byte.  A geometry whose MCU rows do not
    split into the bands, or a subsampling asked for, runs on the module's
    device alone."""

    def __init__(self, cfg: str = "", device="cuda"):
        super().__init__(cfg, device)
        parts = [p for p in cfg.split(":") if p]
        kv = {k: v for k, _, v in (p.partition("=") for p in parts if "=" in p)}
        parts = [p for p in parts if "=" not in p]
        self.quality = int(parts[0]) if parts else 80
        # 0 = auto (restarts are always used)
        self.restart_interval = (int(parts[1]) or None) if len(parts) > 1 else None
        self.subsampling = parts[2] if len(parts) > 2 else None
        self._encoders: dict = {}  # quality -> JpegEncoder
        self._desc: Optional[VideoDesc] = None
        self._rate_bps = parse_rate(kv["rate"]) if "rate" in kv else 0
        self._rc = None
        self.mesh = mesh_from_param(self.device)

    def set_target_bitrate(self, bps: int) -> None:
        """Sender hook for a fixed ``-l`` rate; an explicit ``rate=`` wins."""
        if not self._rate_bps:
            self._rate_bps = int(bps)
            self._rc = None  # rebuilt against the new target at the next geometry

    def compress(self, frame: VideoFrame) -> VideoFrame:
        """Uncompressed frame -> VideoFrame whose data is the JPEG file, a
        1-D uint8 tensor on the module's device (``device.DeviceFile``: the
        entropy assembly runs where the frame was encoded and the send loop
        builds the FEC buffer there; a host consumer reads it as an
        array)."""
        desc = frame.desc
        if self._desc != desc:
            self._encoders.clear()
            self._desc = desc
            if self._rate_bps:
                self._rc = jpeg_controller(self._rate_bps, desc.fps or 30.0, self.quality)
        q = self._rc.value if self._rc is not None else self.quality
        enc = self._encoders.get(q)
        if enc is None:
            with profiler.zone("compress.build"):
                enc = self._encoders[q] = self._encoder(desc, q)
        data = enc.encode_file(on_device(frame.data, self.device))
        if self._rc is not None:
            self._rc.update(len(data))
        return self._out(frame, Codec.JPEG, data)

    def _encoder(self, desc: VideoDesc, quality: int):
        """The banded encoder over the mesh where the geometry splits into
        its bands, else the one-device encoder."""
        if self.mesh is not None and self.subsampling is None:
            try:
                return ShardedJpegEncoder(desc.width, desc.height, self.mesh, desc.color_spec, quality,
                                          restart_interval=self.restart_interval)
            except ValueError as e:
                log.warning(f"jpeg: {desc.width}x{desc.height} on one card: {e}")
        return JpegEncoder(desc.width, desc.height, in_codec=desc.color_spec, quality=quality,
                           restart_interval=self.restart_interval, subsampling=self.subsampling)

    def done(self) -> None:
        self._encoders.clear()


class SessionTranscoder(Transcoder):
    """The CABAC transcoder on a C handle of its own.  The copied module's
    handle (``ops/h264_transcode._handle``) is one per process and not
    reentrant (ROADMAP F2, ref ``h264_transcode.py:40``); each
    :class:`H264Compress` owns one of these instead and destroys its handle
    in :meth:`close`."""

    def __init__(self) -> None:
        self._lh = None
        lh = _handle.__wrapped__()  # a fresh handle, not the module's shared one
        if lh is None:
            raise UnsupportedStream("native transcoder init failed")
        self._lh = lh
        self._sps = None
        self._pps = None
        self._dec = IntraDecoder()

    def close(self) -> None:
        if self._lh is not None:
            lib, h = self._lh
            lib.h264fast_destroy(h)
            self._lh = None

    def __del__(self):  # a module dropped without done(), as FastStreamDecoder's
        self.close()


class H264Compress(VideoCompress):
    """The own H.264 encoder (ref: ``H264Compress``, reference lines 201-379;
    no FFmpeg).

    ``h264[:qp=<0-51>][:mode=i16|i4|pcm|inter][:gop=N][:search=N]
    [:accel=host|device][:deblock=1][:entropy=cavlc|cabac]
    [:subpel=half|quarter][:rate=<bps>][:help]`` -- Annex-B access units
    that any AVC decoder reads.  ``mode=pcm`` is lossless I_PCM;
    ``mode=inter`` runs the IDR + P GOP encoder.  The i16 and inter modes
    run the encoders of ``ops/h264_device.py`` on the module's device unless
    ``accel=host`` (or ``accel=scalar`` for inter) asks for the copies in
    ``ops/h264.py``; ``mode=i4``, ``mode=pcm`` and the in-loop filter signal
    of ``deblock=1`` have no device encoder and run there.  ``entropy=cabac``
    re-encodes each access unit's entropy layer with CABAC on the host
    (``native/h264_entropy.c``), on a handle owned by this module.
    """

    def __init__(self, cfg: str = "", device="cuda"):
        super().__init__(cfg, device)
        self.qp = 26
        self.mode = "i16"
        self.accel = None  # the module's device where the mode has an encoder there
        self.gop = 30
        self.search = 8
        self.deblock = False
        self.entropy = "cavlc"
        self.subpel = "half"
        self._rate_bps = 0
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "qp":
                self.qp = max(0, min(51, int(val)))
            elif key == "mode":
                self.mode = val
            elif key == "gop":
                self.gop = max(1, int(val))
            elif key == "search":
                self.search = max(0, int(val))
            elif key == "accel":
                self.accel = val  # host | device
            elif key == "deblock":
                # signal the in-loop filter (idc=0): intra modes only --
                # P references must match decoder-side filtered pictures
                self.deblock = val not in ("0", "off", "")
            elif key == "entropy":
                if val not in ("cavlc", "cabac"):
                    log.error(f"h264: unknown entropy {val!r}")
                else:
                    self.entropy = val
            elif key == "subpel":
                if val not in ("half", "quarter"):
                    log.error(f"h264: unknown subpel {val!r}")
                else:
                    self.subpel = val
            elif key == "rate":
                self._rate_bps = parse_rate(val)
            elif key == "help":
                print("h264 (own encoder): h264[:qp=<0-51>]"
                      "[:mode=i16|i4|pcm|inter][:gop=N][:search=N]"
                      "[:accel=host|device (i16 and inter: device by default)]"
                      "[:deblock=1 (intra host modes)]"
                      "[:entropy=cavlc|cabac]"
                      "[:rate=<bps> (closed-loop QP adaptation)]")
        if self.accel is None:
            self.accel = "host" if self.mode in ("i4", "pcm") or (self.deblock and self.mode != "inter") else "device"
        self._enc = None
        self._geom = None
        self._rc = None
        self._transcoder = None

    def set_target_bitrate(self, bps: int) -> None:
        """Sender hook for a fixed ``-l`` rate; an explicit ``rate=`` wins."""
        if not self._rate_bps:
            self._rate_bps = int(bps)
            self._rc = None

    def _build(self, desc: VideoDesc, deblock: bool):
        if self.mode == "pcm":
            return h264_ops.PcmEncoder(desc.width, desc.height)
        if self.mode == "inter":
            if self.accel == "device":
                return InterEncoderDevice(desc.width, desc.height, qp=self.qp, gop=self.gop, search=self.search,
                                          subpel=self.subpel, device=self.device)
            if self.subpel == "quarter":
                log.warning("h264: subpel=quarter needs accel=device; using half-pel")
            cls = h264_ops.InterEncoder if self.accel == "scalar" else h264_ops.InterEncoderV
            return cls(desc.width, desc.height, qp=self.qp, gop=self.gop, search=self.search)
        if self.mode == "i4":
            # per-4x4 directional prediction: better compression, host path
            return h264_ops.Intra4x4Encoder(desc.width, desc.height, qp=self.qp, deblock=deblock)
        if self.accel == "device":
            return Intra16EncoderDevice(desc.width, desc.height, qp=self.qp, device=self.device)
        return h264_ops.Intra16EncoderV(desc.width, desc.height, qp=self.qp, deblock=deblock)

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        """Uncompressed frame -> VideoFrame whose data is one Annex-B access
        unit (np.uint8, 1-D)."""
        desc = frame.desc
        data = convert_to(frame, Codec.UYVY, self.device, "h264")
        if data is None:
            return None
        deblock = self.deblock and self.mode in ("i16", "i4") and self.accel != "device"
        if self.deblock and not deblock:
            log.warning("h264: deblock=1 only on intra host paths; ignored")
        if self._rate_bps and self._rc is None and self.mode != "pcm":
            fps = desc.fps or 30.0
            if self.mode == "inter":
                self._rc = GopRateController(self._rate_bps, fps, self.gop, self.qp)
            else:
                self._rc = h264_intra_controller(self._rate_bps, fps, self.qp)
            self._rc_pos = 0
        geom = (desc.width, desc.height, self.qp, self.mode, self.accel, deblock)
        if self._geom != geom:
            self._enc = self._build(desc, deblock)
            self._geom = geom
        if isinstance(self._enc, (Intra16EncoderDevice, InterEncoderDevice)):
            bs = self._enc.encode_uyvy(data)
        else:
            bs = self._enc.encode_uyvy(data.cpu().numpy())
        if self.entropy == "cabac":
            if self.mode == "pcm":
                log.warning("h264: entropy=cabac unsupported for I_PCM; keeping CAVLC")
                self.entropy = "cavlc"
            else:
                if self._transcoder is None:
                    try:
                        self._transcoder = SessionTranscoder()
                    except UnsupportedStream as e:
                        log.warning(f"h264: CABAC transcoder unavailable ({e}); keeping CAVLC")
                        self.entropy = "cavlc"
                if self._transcoder is not None:
                    bs = self._transcoder.transcode_au(bytes(bs))
        if self._rc is not None:
            nbytes = len(bs)
            if self.mode == "inter":
                self._rc_pos += 1
                nqp = self._rc.frame(nbytes, self._rc_pos % self.gop == 0)
            else:
                nqp = self._rc.update(nbytes)
            if nqp != self.qp:
                # rebuilt at the next frame for intra; the next GOP opens
                # with an IDR for inter, so the reference chain holds
                self.qp = nqp
                self._geom = None
        out = VideoFrame(desc.with_(color_spec=Codec.H264), [np.frombuffer(bytes(bs), np.uint8)], frame.timestamp)
        out.callbacks.update(frame.callbacks)
        if self.mode == "inter":
            # P frames depend on the previous picture; receivers use this
            # to gate display on intact references (ref: interframe flag)
            out.callbacks["frame_type"] = (
                "I" if getattr(self._enc, "_frame_idx", 1) % self.gop == 1 or self.gop == 1 else "P")
        return out

    def done(self) -> None:
        if self._transcoder is not None:
            self._transcoder.close()
            self._transcoder = None


def convert_to(frame: VideoFrame, codec: Codec, device, who: str) -> Optional[torch.Tensor]:
    """The frame's data as ``codec`` on ``device``, [H, linesize]: converted
    there when the frame has another codec (None, with an error, where no
    conversion exists)."""
    desc = frame.desc
    data = on_device(frame.data, device)
    if desc.color_spec != codec:
        if pixfmt.get_decoder_from_to(desc.color_spec, codec) is None:
            log.error(f"{who}: cannot convert from {desc.color_spec.name}")
            return None
        data = pixfmt.convert_frame(data, desc.width, desc.color_spec, codec)
    return data.reshape(desc.height, -1)


def uyvy_planes(data: torch.Tensor, width: int, shift: int = 0):
    """A UYVY frame [H, >= 2 * width] -> its Y, Cb and Cr planes as int32
    on its device, each shifted left by ``shift`` bits."""
    a = data[:, : 2 * width].to(torch.int32)
    return a[:, 1::2] << shift, a[:, 0::4] << shift, a[:, 2::4] << shift


class JpegXsCompress(VideoCompress):
    """JPEG XS-architecture wavelet compression (ref role:
    src/video_compress/jpegxs.cpp over SVT-JPEG-XS; the reference package's
    own 5/3-DWT codec, :mod:`ultragrid_tpu_torch.ops.jpegxs`).

    Config: ``jpegxs[:quality]`` (default 90; 100 = lossless).  Takes UYVY
    (4:2:2 planes, split on the module's device); other codecs are converted
    to UYVY there.
    """

    def __init__(self, cfg: str = "", device="cuda"):
        super().__init__(cfg, device)
        self.quality = int(cfg) if cfg else 90
        self.codec = JpegXsCodec(nlx=3, nly=1, quality=self.quality, device=self.device)

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        data = convert_to(frame, Codec.UYVY, self.device, "jpegxs")
        if data is None:
            return None
        stream = self.codec.encode_planes(uyvy_planes(data, frame.desc.width))
        return self._out(frame, Codec.JPEG_XS, np.frombuffer(stream, np.uint8))


class CineformCompress(VideoCompress):
    """CineForm wavelet compression (ref role: src/video_compress/cineform.cpp
    over the CineForm SDK).

    As the reference: real CFHD samples (:mod:`ultragrid_tpu_torch.ops.
    cfhd_bitstream`, host numpy; the frame comes down once) whenever the
    geometry allows (width % 16 == 0, height % 8 == 0) and quality < 100;
    otherwise the own lossless-capable UCF1 container
    (:mod:`ultragrid_tpu_torch.ops.cineform`, its 2/6 wavelet on the module's
    device).  Both decode through the ``cineform`` decompress module.

    Config: ``cineform[:quality]`` (default 90; 100 = lossless UCF1).  Takes
    UYVY; other codecs are converted to UYVY on the module's device.
    """

    def __init__(self, cfg: str = "", device="cuda"):
        super().__init__(cfg, device)
        self.quality = int(cfg) if cfg else 90
        self.codec = CineformCodec(levels=3, quality=self.quality, device=self.device)
        self._cfhd = None  # CfhdEncoder of the last geometry, built lazily

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        desc = frame.desc
        data = convert_to(frame, Codec.UYVY, self.device, "cineform")
        if data is None:
            return None
        if self.quality < 100 and desc.width % 16 == 0 and desc.height % 8 == 0:
            if self._cfhd is None or (self._cfhd.width, self._cfhd.height) != (desc.width, desc.height):
                self._cfhd = CfhdEncoder(desc.width, desc.height, quality=self.quality)
            stream = self._cfhd.encode_uyvy(data[:, : 2 * desc.width].cpu().numpy())
        else:
            stream = self.codec.encode_planes(uyvy_planes(data, desc.width))
        return self._out(frame, Codec.CFHD, np.frombuffer(stream, np.uint8))


class J2kCompress(VideoCompress):
    """The own JPEG 2000 encoder (ref role: src/video_compress/cmpto_j2k.cpp
    over the Comprimato SDK; the reference package's T.800 encoder,
    :mod:`ultragrid_tpu_torch.ops.j2k`: numpy and ``native/j2k_t1.c`` on the
    host, as in the reference).

    Config: ``cmpto_j2k[:quality]`` / ``j2k[:quality]`` (default 100 =
    lossless RCT + 5/3).  Takes RGB; other codecs are converted to RGB on
    the module's device, and the RGB frame comes down once.
    """

    def __init__(self, cfg: str = "", device="cuda"):
        super().__init__(cfg, device)
        self.quality = int(cfg) if cfg else 100
        self.enc = J2KEncoder(levels=5, quality=self.quality, mct=True)

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        desc = frame.desc
        data = convert_to(frame, Codec.RGB, self.device, "j2k")
        if data is None:
            return None
        rgb = data[:, : 3 * desc.width].cpu().numpy().reshape(desc.height, desc.width, 3)
        stream = self.enc.encode([rgb[:, :, i] for i in range(3)])
        return self._out(frame, Codec.J2KR, np.frombuffer(stream, np.uint8))


class ApvCompress(VideoCompress):
    """APV-architecture compression (ref role: src/video_compress/openapv.cpp
    over liboapv, ISO/IEC 23090-33; the reference package's tile / DCT /
    Rice codec, :mod:`ultragrid_tpu_torch.ops.apv`, its transform on the
    module's device).

    Config: ``openapv[:qp=N][:tile_w=N][:tile_h=N]`` or ``openapv:N`` (qp,
    default 18; 0 = near-lossless).  Takes UYVY, coded as 10-bit 4:2:2 (the
    8 -> 10 bit widening on the module's device); other codecs are converted
    to UYVY there.
    """

    def __init__(self, cfg: str = "", device="cuda"):
        super().__init__(cfg, device)
        qp, tw, th = 18, 1920, 1080
        for tok in filter(None, cfg.split(":")):
            if tok.isdigit():
                qp = int(tok)
            elif tok.startswith("qp="):
                qp = int(tok[3:])
            elif tok.startswith("tile_w="):
                tw = int(tok[7:])
            elif tok.startswith("tile_h="):
                th = int(tok[7:])
        self.codec = ApvCodec(qp=qp, bit_depth=10, tile_w=tw, tile_h=th, device=self.device)

    def compress(self, frame: VideoFrame) -> Optional[VideoFrame]:
        data = convert_to(frame, Codec.UYVY, self.device, "openapv")
        if data is None:
            return None
        stream = self.codec.encode_planes(uyvy_planes(data, frame.desc.width, shift=2))  # 8 -> 10 bit
        return self._out(frame, Codec.APV, np.frombuffer(stream, np.uint8))


register_module("none", LibraryClass.VIDEO_COMPRESS, NoneCompress)
register_module("cmpto_j2k", LibraryClass.VIDEO_COMPRESS, J2kCompress)
register_module("j2k", LibraryClass.VIDEO_COMPRESS, J2kCompress)
register_module("openapv", LibraryClass.VIDEO_COMPRESS, ApvCompress)
register_module("apv", LibraryClass.VIDEO_COMPRESS, ApvCompress)  # alias
register_module("jpegxs", LibraryClass.VIDEO_COMPRESS, JpegXsCompress)
register_module("cineform", LibraryClass.VIDEO_COMPRESS, CineformCompress)
register_module("h264", LibraryClass.VIDEO_COMPRESS, H264Compress)
register_module("uyvy", LibraryClass.VIDEO_COMPRESS, UyvyCompress)
register_module("dxt", LibraryClass.VIDEO_COMPRESS, DxtCompress)
register_module("cuda_dxt", LibraryClass.VIDEO_COMPRESS, DxtCompress)  # alias
register_module("jpeg", LibraryClass.VIDEO_COMPRESS, JpegCompress)
register_module("gpujpeg", LibraryClass.VIDEO_COMPRESS, JpegCompress)  # alias


def compress_init(spec: str, device="cuda") -> VideoCompress:
    """ref: compress_init, src/video_compress.cpp:212; the module runs on
    ``device``."""
    name, _, cfg = spec.partition(":")
    cls = load_library(name, LibraryClass.VIDEO_COMPRESS)
    if cls is None:
        # control-socket commands use the reference's capitalised module
        # names ("compress JPEG:60"); registry keys are lowercase
        cls = load_library(name.lower(), LibraryClass.VIDEO_COMPRESS)
    if cls is None:
        raise ValueError(f"unknown compression {name!r} (the port has: "
                         f"{', '.join(list_modules(LibraryClass.VIDEO_COMPRESS))})")
    return cls(cfg, device=device)


class CompressDriver:
    """Worker-thread compress stage with runtime reconfiguration (ref:
    compress driver, src/video_compress.cpp:79-209).

    Push frames with :meth:`enqueue`; pop results with :meth:`pop`.  A
    ``MsgChangeCompress`` on the module swaps in a new codec without dropping
    frames (the new module is built off-thread, then swapped in one
    assignment).  On the card the worker enqueues its device work on
    ``stream``, the pipeline's one stream (see ``pipeline/sender.py``).
    Each queue holds ``queue_len`` frames (the loopback's ``BUFF_MAX_LEN``).
    """

    def __init__(self, spec: str, parent: Optional[Module] = None, device="cuda",
                 stream: Optional[torch.cuda.Stream] = None, queue_len: int = 2):
        self.device = get_device(device)
        self.stream = stream
        self.module = Module("compress", parent)
        self.module.msg_callback = self._on_message
        self._impl = compress_init(spec, self.device)
        self._lock = threading.Lock()
        self.in_queue: "queue.Queue" = queue.Queue(maxsize=queue_len)
        self.out_queue: "queue.Queue" = queue.Queue(maxsize=queue_len)
        self._thread = threading.Thread(target=self._worker, name="compress", daemon=True)
        self._thread.start()

    @property
    def impl(self) -> VideoCompress:
        return self._impl

    def _on_message(self, msg: Message) -> Response:
        if isinstance(msg, MsgChangeCompress):
            try:
                new_impl = compress_init(msg.config, self.device)
            except Exception as e:  # noqa: BLE001 - reported to the sender of the message
                return Response(RESPONSE_INT_SERV_ERR, str(e))
            with self._lock:
                old, self._impl = self._impl, new_impl
            old.done()
            log.notice(f"compression changed to {msg.config}")
            return Response(RESPONSE_OK)
        return Response(RESPONSE_INT_SERV_ERR, "unsupported message")

    def _worker(self) -> None:
        with stream_context(self.stream):
            while True:
                item = self.in_queue.get()
                if item is None:
                    self.out_queue.put(None)
                    return
                frame, t_enqueue = item
                frame.compress_start = time.monotonic()
                key = video_rtp_ts(frame.timestamp) if frame.timestamp >= 0 else None
                profiler.interval("compress.queue", t_enqueue, key)
                with self._lock:
                    impl = self._impl
                try:
                    out = self._compress_one(impl, frame, key)
                except Exception as e:  # noqa: BLE001 - a codec failure drops the
                    # frame, not the compress thread and with it the sender
                    log.error(f"compress: dropping frame: {e}")
                    continue
                if out is not None:
                    out.compress_start = frame.compress_start
                    out.compress_end = time.monotonic()
                    self.out_queue.put(out)

    def _compress_one(self, impl, frame, key=None):
        if len(frame.tiles) > 1:
            # per-tile fan-out (ref: sync tile API fanned out via
            # task_run_async, src/video_compress.cpp:79-120)
            outs = []
            for t in frame.tiles:
                sub = VideoFrame(frame.desc.with_(tile_count=1), [t])
                sub.timestamp = frame.timestamp
                res = impl.compress(sub)
                if res is None:
                    return None
                outs.append(res)
            out = VideoFrame(outs[0].desc.with_(tile_count=len(outs)), [o.data for o in outs])
            out.timestamp = frame.timestamp
            return out
        with profiler.zone("compress", frame=key):
            return impl.compress(frame)

    def enqueue(self, frame: Optional[VideoFrame]) -> None:
        """Hand a frame to the worker; blocks while the queue is full.  The
        frame's ``compress.queue`` span runs from this call to the worker's
        ``get``, a blocked put included."""
        self.in_queue.put(None if frame is None else (frame, time.monotonic_ns()))

    def pop(self, timeout: Optional[float] = None) -> Optional[VideoFrame]:
        return self.out_queue.get(timeout=timeout)

    def stop(self) -> None:
        self.in_queue.put(None)
        self._thread.join(timeout=5)
        self._impl.done()
