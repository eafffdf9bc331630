"""Video compression module of the port: JPEG on tensors.

Counterpart of ``JpegCompress`` in ``ultragrid_tpu/modules/video_compress.py``
(reference modules/video_compress.py:129-196) without rate control.  It is
not registered with the CLI yet: the live sender still imports the jax
packetizer (ROADMAP.md: a jax-free FEC descriptor, then live sessions).
"""

from __future__ import annotations

from typing import Optional

from ultragrid_tpu_torch.device import get_device, on_device
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame


class JpegCompress:
    """Config ``jpeg[:quality][:restart_interval][:subsampling]`` (quality
    default 80; subsampling 422 for YCbCr inputs, 444 for RGB, or 420).
    Frames are encoded on ``device``, the card unless the caller names
    another: an array frame is copied there, a tensor frame must already be
    there."""

    def __init__(self, cfg: str = "", device="cuda"):
        parts = [p for p in cfg.split(":") if p]
        if any("=" in p for p in parts):
            raise NotImplementedError("jpeg key=value options (rate=) are not ported yet")
        self.cfg = cfg
        self.device = get_device(device)
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
        out = VideoFrame(desc.with_(color_spec=Codec.JPEG), [data])
        out.timestamp = frame.timestamp
        return out

    def done(self) -> None:
        self._encoder = None
