"""Row-sharded deinterlace with a one-row halo between blocks.

Port of ``ultragrid_tpu/parallel/sharded_post.py``.  The reference scales
frame size by splitting one frame into independently processed tiles (ref:
vf_split / vf_merge_tiles, src/utils/vf_split.h:64-76).  Deinterlace blend
and linear (ref: vc_deinterlace_ex, src/video_codec.c:82-85) need one row of
the NEXT block: the reference moves it with one ``lax.ppermute``; here it is
block ``i + 1``'s first row copied to block ``i``'s device (a peer copy
across cards, nothing on one card).  The last block, which has no next one,
uses its own boundary row, the reference's blend-with-itself edge.

Byte-equal to ``ops/postprocess.deinterlace_blend`` / ``deinterlace_linear``
on the whole frame.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List

import torch

from ultragrid_tpu_torch.ops.postprocess import _avg_lines
from ultragrid_tpu_torch.parallel.mesh import Mesh, shard_frame_rows
from ultragrid_tpu_torch.types import Codec


def _halo_next_row(blocks: List[torch.Tensor], i: int, self_boundary: torch.Tensor) -> torch.Tensor:
    """First row of block ``i + 1`` on block ``i``'s device; the last block
    gets ``self_boundary``."""
    if i == len(blocks) - 1:
        return self_boundary
    return blocks[i + 1][:1].to(blocks[i].device)


def _blend_block(blocks, i: int, codec: Codec) -> torch.Tensor:
    blk = blocks[i]
    nxt = torch.cat([blk[1:], _halo_next_row(blocks, i, blk[-1:])], dim=0)
    return _avg_lines(blk, nxt, codec)


def _linear_block(blocks, i: int, codec: Codec) -> torch.Tensor:
    # block heights are even, so local line parity is global line parity and
    # the next block's row 0 is the next EVEN line: the same one-row halo;
    # the frame's last even line (blk[-2]) interpolates with itself
    blk = blocks[i]
    even = blk[0::2]
    nxt = torch.cat([even[1:], _halo_next_row(blocks, i, blk[-2:-1])], dim=0)
    interp = _avg_lines(even, nxt, codec)
    return torch.stack([even, interp], dim=1).reshape(-1, blk.shape[1])[: blk.shape[0]]


_KINDS = {"blend": _blend_block, "linear": _linear_block}


@lru_cache(maxsize=64)
def make_sharded_deinterlace(mesh: Mesh, codec: Codec, kind: str = "blend"):
    """The deinterlace over the mesh's 'spatial' axis (ref
    ``make_sharded_deinterlace``, sharded_post.py:68, cached as the
    reference's): a callable from the frame's row blocks, one a device as
    :func:`~ultragrid_tpu_torch.parallel.mesh.shard_frame_rows` gives them,
    to the deinterlaced blocks, each on its block's device with the one-row
    halo from the next."""
    block, codec = _KINDS[kind], Codec(codec)
    n = mesh.shape["spatial"]

    def deinterlace(blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        if len(blocks) != n:
            raise ValueError(f"{len(blocks)} row blocks for a 'spatial' axis of {n}")
        return [block(blocks, i, codec) for i in range(n)]

    return deinterlace


def sharded_deinterlace(frame, codec: Codec, mesh: Mesh, kind: str = "blend") -> List[torch.Tensor]:
    """Shard ``frame`` [H, linesize] (array or tensor) over the mesh's
    'spatial' axis and deinterlace it: the row blocks, each computed on its
    own device with the one-row halo from the next, never gathered."""
    n = mesh.shape["spatial"]
    h = frame.shape[0]
    if h % n or (h // n) % 2:
        raise ValueError(f"height {h} must split into even-height blocks over {n} shards")
    return make_sharded_deinterlace(mesh, Codec(codec), kind)(shard_frame_rows(frame, mesh))
