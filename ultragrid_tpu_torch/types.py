"""The video types the port uses: codec ids, video description, frames.

The port's own copy of the part of ``ultragrid_tpu/types.py`` it calls, so
that it imports nothing of the JAX package.  Codec ids keep the reference's
``IntEnum`` values (ref: codec_t, src/types.h:62-111); the per-codec line
geometry is the reference table's (src/video_codec.c:123-207) for the codecs
the port takes.  ``tests/test_torch_types.py`` holds every value here equal
to the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional


class Codec(enum.IntEnum):
    """The codec ids the port reads or writes (values as the reference's)."""

    NONE = 0
    RGBA = 1
    UYVY = 2
    YUYV = 3
    RGB = 12
    JPEG = 13


class InterlacingType(enum.IntEnum):
    """Interlacing (ref: src/types.h interlacing_t)."""

    PROGRESSIVE = 0
    UPPER_FIELD_FIRST = 1
    LOWER_FIELD_FIRST = 2
    INTERLACED_MERGED = 3
    SEGMENTED_FRAME = 4


# codec -> (bytes per pixel block, pixels per block, horizontal alignment)
_LINE_GEOMETRY = {
    Codec.RGBA: (4, 1, 1),
    Codec.UYVY: (4, 2, 2),
    Codec.YUYV: (4, 2, 2),
    Codec.RGB: (3, 1, 1),
}


def vc_get_linesize(width: int, codec: Codec) -> int:
    """Aligned byte length of one line (ref: src/video_codec.c:508-522)."""
    codec = Codec(codec)
    if codec not in _LINE_GEOMETRY:
        raise ValueError(f"no line geometry for {codec.name} in the port")
    block_bytes, block_pixels, h_align = _LINE_GEOMETRY[codec]
    width = (width + h_align - 1) // h_align * h_align
    return (width + block_pixels - 1) // block_pixels * block_bytes


@dataclasses.dataclass(frozen=True)
class VideoDesc:
    """Format descriptor (ref: struct video_desc, src/types.h:181-195)."""

    width: int
    height: int
    color_spec: Codec
    fps: float = 30.0
    interlacing: InterlacingType = InterlacingType.PROGRESSIVE
    tile_count: int = 1

    def linesize(self) -> int:
        return vc_get_linesize(self.width, self.color_spec)

    def with_(self, **kw: Any) -> "VideoDesc":
        return dataclasses.replace(self, **kw)


class VideoFrame:
    """A frame: one array or tensor per tile plus its descriptor (ref:
    struct video_frame, src/types.h:301-342).  ``data`` is the first tile."""

    __slots__ = ("desc", "tiles", "timestamp")

    def __init__(self, desc: VideoDesc, tiles: Optional[list] = None, timestamp: float = -1.0):
        self.desc = desc
        self.tiles = tiles if tiles is not None else []
        self.timestamp = timestamp  # seconds

    @property
    def data(self):
        return self.tiles[0]

    def __repr__(self) -> str:
        return f"VideoFrame({self.desc})"
