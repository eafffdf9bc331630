"""Video compression modules of the port: passthrough, UYVY, DXT and JPEG on
tensors.

Counterparts of ``NoneCompress``, ``UyvyCompress``, ``DxtCompress`` and
``JpegCompress`` in ``ultragrid_tpu/modules/video_compress.py`` (reference
lines 49-196; JPEG without rate control), registered in the port's registry
under the reference's names (reference lines 568-580).  Each runs on
``device``, the card unless the caller names another: an array frame is
copied there, a tensor frame must already be there.
"""

from __future__ import annotations

from typing import Optional

from ultragrid_tpu_torch.device import get_device, on_device
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.ops import dxt as dxt_ops
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame


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
    """Config ``jpeg[:quality][:restart_interval][:subsampling]`` (quality
    default 80; subsampling 422 for YCbCr inputs, 444 for RGB, or 420)."""

    def __init__(self, cfg: str = "", device="cuda"):
        parts = [p for p in cfg.split(":") if p]
        if any("=" in p for p in parts):
            raise NotImplementedError("jpeg key=value options (rate=) are not ported yet")
        super().__init__(cfg, device)
        self.quality = int(parts[0]) if parts else 80
        # 0 = auto (restarts are always used)
        self.restart_interval = (int(parts[1]) or None) if len(parts) > 1 else None
        self.subsampling = parts[2] if len(parts) > 2 else None
        self._encoder: Optional[JpegEncoder] = None
        self._desc: Optional[VideoDesc] = None

    def compress(self, frame: VideoFrame) -> VideoFrame:
        """Uncompressed frame -> VideoFrame whose data is the JPEG file
        (np.uint8, 1-D)."""
        desc = frame.desc
        if self._desc != desc:
            self._desc = desc
            self._encoder = JpegEncoder(
                desc.width, desc.height, in_codec=desc.color_spec,
                quality=self.quality, restart_interval=self.restart_interval,
                subsampling=self.subsampling)
        data = self._encoder.encode(on_device(frame.data, self.device))
        return self._out(frame, Codec.JPEG, data)

    def done(self) -> None:
        self._encoder = None


register_module("none", LibraryClass.VIDEO_COMPRESS, NoneCompress)
register_module("uyvy", LibraryClass.VIDEO_COMPRESS, UyvyCompress)
register_module("dxt", LibraryClass.VIDEO_COMPRESS, DxtCompress)
register_module("cuda_dxt", LibraryClass.VIDEO_COMPRESS, DxtCompress)  # alias
register_module("jpeg", LibraryClass.VIDEO_COMPRESS, JpegCompress)
register_module("gpujpeg", LibraryClass.VIDEO_COMPRESS, JpegCompress)  # alias
