"""Video decompression module of the port: JPEG to UYVY or RGB on tensors.

Counterpart of ``VideoDecompress`` and ``JpegDecompress`` in
``ultragrid_tpu/modules/video_decompress.py`` (reference lines 25-37 and
79-87; ref: src/video_decompress.h:90-199, src/video_decompress/gpujpeg.c).
Like the port's ``JpegCompress`` it is not registered with the CLI yet
(ROADMAP.md: live sessions).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, decode_jpeg_to_frame
from ultragrid_tpu_torch.types import Codec, VideoFrame


class VideoDecompress:
    #: (in_codec, out_codec) pairs this module supports
    SUPPORTS: List[Tuple[Codec, Codec]] = []

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        raise NotImplementedError

    def done(self) -> None:
        pass


class JpegDecompress(VideoDecompress):
    """JPEG -> UYVY / RGB on ``device``, the card unless the caller names
    another; the output frame's data is a uint8 tensor there.  One decoder
    per module keeps the per-stream matrices of its session."""

    SUPPORTS = [(Codec.JPEG, Codec.UYVY), (Codec.JPEG, Codec.RGB)]

    def __init__(self, device="cuda"):
        self.decoder = JpegDecoder(device)

    def decompress(self, frame: VideoFrame, out_codec: Codec) -> Optional[VideoFrame]:
        return decode_jpeg_to_frame(frame, out_codec, self.decoder)
