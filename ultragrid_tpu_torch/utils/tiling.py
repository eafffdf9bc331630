"""Video modes & frame tiling (ref: src/utils/video.c:60-74, vf_split.cpp).

Port of ``ultragrid_tpu/utils/tiling.py``.  Multi-tile modes split one
logical frame into independent substreams (the reference's scaling mechanism
for dual-link/3D/tiled-4K); each tile travels as its own RTP substream and
is re-merged at the receiver.  Tiles are views of the frame's tensor, and
the merge runs on the tiles' device.
"""

from __future__ import annotations

import enum

import torch

from ultragrid_tpu_torch.types import VideoFrame, vc_get_linesize


class VideoMode(enum.Enum):
    """ref: video_mode_info_map, src/utils/video.c:67-74 (name, x, y)."""

    NORMAL = ("normal", 1, 1)
    DUAL = ("dual-link", 1, 2)
    STEREO = ("3D", 2, 1)
    TILED_4K = ("tiled-2x2", 2, 2)
    THREE_X1 = ("3x1", 3, 1)

    @property
    def x(self) -> int:
        return self.value[1]

    @property
    def y(self) -> int:
        return self.value[2]

    @staticmethod
    def from_str(name: str) -> "VideoMode":
        for m in VideoMode:
            if m.value[0] == name:
                return m
        raise ValueError(f"unknown video mode {name!r}")


def vf_split(frame: VideoFrame, x_count: int, y_count: int) -> VideoFrame:
    """Split a single-tile frame into an x_count*y_count tile grid
    (ref: vf_split, src/utils/vf_split.cpp:50-100; tile order row-major)."""
    desc = frame.desc
    if desc.width % x_count or desc.height % y_count:
        raise ValueError(f"{desc.width}x{desc.height} does not split into {x_count}x{y_count} tiles")
    tw, th = desc.width // x_count, desc.height // y_count
    src = frame.data
    out_ls = vc_get_linesize(tw, desc.color_spec)
    tiles = [src[ty * th : (ty + 1) * th, tx * out_ls : (tx + 1) * out_ls]
             for ty in range(y_count) for tx in range(x_count)]
    out = VideoFrame(desc.with_(width=tw, height=th, tile_count=x_count * y_count), tiles)
    out.timestamp = frame.timestamp
    return out


def vf_merge_tiles(frame: VideoFrame, x_count: int, y_count: int) -> VideoFrame:
    """Inverse of vf_split (ref: vf_merge_tiles, vf_split.cpp:134)."""
    desc = frame.desc
    if desc.tile_count != x_count * y_count:
        raise ValueError(f"{desc.tile_count} tiles do not form a {x_count}x{y_count} grid")
    rows = [torch.cat(frame.tiles[ty * x_count : (ty + 1) * x_count], dim=1) for ty in range(y_count)]
    out_desc = desc.with_(width=desc.width * x_count, height=desc.height * y_count, tile_count=1)
    out = VideoFrame(out_desc, [torch.cat(rows, dim=0)])
    out.timestamp = frame.timestamp
    return out
