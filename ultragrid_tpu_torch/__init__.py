"""ultragrid_tpu_torch — the PyTorch + CUDA port of ultragrid_tpu.

The sender's flagship device step (UYVY frame -> JPEG encode -> LDGM parity
over the slot container) runs here on tensors: two hand-written Hopper
kernels on an NVIDIA card (``csrc/``), and their plain PyTorch versions on
the CPU; so do the receive path and the local loop (capture, filters,
postprocess, displays: ``modules/``, ``pipeline/loop.py``).  The JAX package ``ultragrid_tpu`` stays the reference; the port
imports nothing of it.  It keeps its own copies of the video types
(:mod:`ultragrid_tpu_torch.types`) and its own loader for the shared host C
stages in ``native/`` (:mod:`ultragrid_tpu_torch.native`).
"""

from ultragrid_tpu_torch.device import get_device  # noqa: F401
from ultragrid_tpu_torch.types import (  # noqa: F401
    Codec,
    VideoDesc,
    VideoFrame,
    InterlacingType,
    get_bpp,
    get_bits_per_component,
    vc_get_linesize,
    vc_get_size,
    vc_get_datalen,
)

__version__ = "0.2.0"
