"""Multi-device scaling over a device mesh (port of ``ultragrid_tpu/parallel``).

The reference scales by spatial tiling (tiled 4K/8K as independent
substreams, ref: src/utils/video.c:67-74) and by round-robin over the CUDA
devices of one process (ref: src/host.h:98).  Here:

* **spatial**: a frame's rows split into one band per device; conversions
  and the JPEG and H.264 encodes are band-local, deinterlace takes a one-row
  halo from the next band (``sharded_post``);
* **data**: a batch of frames (or tiles) split over devices.

The mesh is a list of devices in one process (``mesh.py``); a device may
repeat, so several bands can share one card.
"""

from ultragrid_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    replicated,
    shard_batch,
    shard_frame_rows,
)
