"""Postprocess on tensors: the nearest-neighbour scale.

Port of ``scale_nearest`` in ``ultragrid_tpu/ops/postprocess.py:28-43``
(ref: vo_postprocess/scale.c, GL nearest sampling over texels), the
``scale_to`` pre-scale of the sender step.  The rest of the reference
module (deinterlace, crop, filters) is not ported yet.
"""

from __future__ import annotations

import torch

from ultragrid_tpu_torch.types import Codec, get_codec_info


def scale_nearest(src: torch.Tensor, width: int, codec: Codec, new_width: int, new_height: int) -> torch.Tensor:
    """Nearest-neighbour scale at pixel-block granularity (UYVY scales in
    2-pixel texels, like the reference's RGBA-texture trick).

    The texel centre of output index i is ``(i + 0.5) * n_in / n_out`` in
    float32, evaluated in the reference's order and truncated, so the
    sampled indices are the reference's.
    """
    info = get_codec_info(codec)
    bpx, bby = info.block_size_pixels, info.block_size_bytes
    h = src.shape[0]
    blocks_in, blocks_out = width // bpx, new_width // bpx
    g = src[:, : blocks_in * bby].reshape(h, blocks_in, bby)

    def centres(n_out: int, n_in: int) -> torch.Tensor:
        i = torch.arange(n_out, dtype=torch.float32, device=src.device)
        return ((i + 0.5) * n_in / n_out).to(torch.int64)

    out = g[centres(new_height, h)][:, centres(blocks_out, blocks_in)]
    return out.reshape(new_height, blocks_out * bby)
