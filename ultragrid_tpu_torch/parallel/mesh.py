"""A device mesh for frame-parallel execution, as a list of devices.

Port of ``ultragrid_tpu/parallel/mesh.py``.  The reference's model is one
process driving several cards: a tiled 8K frame's tiles are independent
substreams, round-robined over the CUDA devices of one process (ref:
src/host.h:98, src/utils/video.c:67-74).  So the port's mesh is not a
``torch.distributed`` process group: it is a ``[data, spatial]`` grid of
``torch.device`` in one process, and "sharding" a tensor splits it into
per-device blocks, each moved to its device.  No global array is built; the
traffic between blocks is the one-row halo of ``sharded_post`` (a peer copy
across cards, nothing on one card) and the live decode's gather of its
bands onto the display's card (``ShardedJpegDecoder.decode_frame``).

A device may repeat: ``make_mesh(devices=["cuda:0"] * 4)`` puts four row
bands on one card, as the reference's tiles share one GPU where it has one.

The live session takes its mesh from ``--param cuda-device=<i,j,...>`` (the
CLI's ``--cuda-device``, the reference's ``cuda_devices[]``, src/host.h:98-100):
:func:`mesh_from_param`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device
from ultragrid_tpu_torch.utils.params import add_to_param, get_commandline_param

add_to_param("cuda-device",
             "* cuda-device=<i,j,...>\n"
             "  the CUDA cards a JPEG session splits each frame over, one row band a card, "
             "for both its encode and its decode (ref: --cuda-device, src/host.h:98-100); "
             "unset or one card: the session's device alone.  On the CPU, as many CPU entries")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``[data, spatial]`` grid of devices.  Hashable, and equal to any
    mesh with the same grid."""

    grid: Tuple[Tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict:
        return {"data": len(self.grid), "spatial": len(self.grid[0])}

    @property
    def devices(self) -> List[torch.device]:
        """Every device, data-major."""
        return [d for row in self.grid for d in row]

    @property
    def spatial(self) -> List[torch.device]:
        """The devices of the first data row: where row bands go."""
        return list(self.grid[0])


def make_mesh(
    n_devices: Optional[int] = None,
    data: int = 1,
    spatial: Optional[int] = None,
    devices: Optional[Sequence] = None,
    device="cuda",
) -> Mesh:
    """A ``("data", "spatial")`` mesh over ``devices``, else over the first
    ``n_devices`` CUDA cards (all of them by default; it raises with fewer),
    or over ``n_devices`` CPU entries when ``device`` is the CPU."""
    if devices is not None:
        devs = [get_device(str(d)) for d in devices]
        # a card named without its index is the current one
        devs = [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
                for d in devs]
        if n_devices is not None:
            devs = devs[:n_devices]
    else:
        base = get_device(device)
        if base.type == "cuda":
            count = torch.cuda.device_count()
            n = count if n_devices is None else n_devices
            if n > count:
                raise RuntimeError(f"mesh of {n} cards requested, {count} present")
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            devs = [base] * (1 if n_devices is None else n_devices)
    n = len(devs)
    if n == 0:
        raise ValueError("mesh of no devices")
    if spatial is None:
        spatial = n // data
    if data * spatial != n:
        raise ValueError(f"mesh {data}x{spatial} != {n} devices")
    grid = tuple(tuple(devs[i * spatial:(i + 1) * spatial]) for i in range(data))
    return Mesh(grid)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    # torch takes no read-only memory: such an array is copied
    return torch.from_numpy(x if x.flags.writeable and x.flags.c_contiguous else x.copy())


def split_rows(x, n: int) -> List:
    """``x`` cut into ``n`` equal row blocks (raises unless they divide)."""
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} rows do not split into {n} equal blocks")
    step = x.shape[0] // n
    return [x[i * step:(i + 1) * step] for i in range(n)]


def shard_frame_rows(frame, mesh: Mesh) -> List[torch.Tensor]:
    """A frame ``[H, linesize]`` (array or tensor) -> one row band per
    device of the 'spatial' axis, each on its device."""
    return [b.to(d) for b, d in zip(split_rows(_tensor(frame), len(mesh.spatial)), mesh.spatial)]


def shard_batch(frames, mesh: Mesh) -> List[List[torch.Tensor]]:
    """A batch ``[B, H, linesize]`` -> blocks ``[data][spatial]``: frames
    split over 'data', rows over 'spatial', each block on its device."""
    x = _tensor(frames)
    out = []
    for chunk, row in zip(split_rows(x, mesh.shape["data"]), mesh.grid):
        step = chunk.shape[1] // len(row)
        if chunk.shape[1] % len(row):
            raise ValueError(f"{chunk.shape[1]} rows do not split into {len(row)} equal blocks")
        out.append([chunk[:, i * step:(i + 1) * step].to(d) for i, d in enumerate(row)])
    return out


def replicated(x, mesh: Mesh) -> List[torch.Tensor]:
    """One copy of ``x`` per device of the mesh, data-major."""
    t = _tensor(x)
    return [t.to(d) for d in mesh.devices]


def cuda_device_list(value: Optional[str]) -> List[int]:
    """The card indices of a ``cuda-device`` value ("0,1,2,3"); [] for
    None or an empty value.  Raises ValueError for anything else."""
    if not value:
        return []
    try:
        idx = [int(x) for x in value.split(",")]
    except ValueError:
        raise ValueError(f"cuda-device: {value!r} is not a list of card indices") from None
    if any(i < 0 for i in idx):
        raise ValueError(f"cuda-device: {value!r} names a negative index")
    return idx


def mesh_from_param(device="cuda") -> Optional[Mesh]:
    """The row-band mesh of the ``cuda-device`` param for a pipeline on
    ``device``: one band a listed card, in the list's order, or on the CPU
    as many CPU entries as the list has.  None where the param is unset or
    names one card: the pipeline then runs on ``device`` alone, as
    without it."""
    idx = cuda_device_list(get_commandline_param("cuda-device"))
    if len(idx) < 2:
        return None
    dev = get_device(str(device))
    if dev.type != "cuda":
        return make_mesh(len(idx), device=str(dev))
    if max(idx) >= torch.cuda.device_count():
        raise ValueError(f"cuda-device: card {max(idx)} requested, {torch.cuda.device_count()} present")
    return make_mesh(devices=[torch.device("cuda", i) for i in idx])
