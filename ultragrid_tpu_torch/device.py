"""Device selection for the PyTorch port.

A float32 matrix product on the card must run in full float32: the JPEG front
end rounds its products to integers, and TF32 (about three decimal digits)
would move coefficients.  Both switches are set once, here, on import.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def get_device(name: str = "cuda") -> torch.device:
    """``torch.device(name)``; raises when CUDA is asked for and absent.

    There is no fallback to the CPU: a caller that asked for the card and
    silently got the CPU would measure and test the wrong thing.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is False")
    return dev


def pipeline_stream(device: torch.device) -> Optional[torch.cuda.Stream]:
    """The one CUDA stream a pipeline on ``device`` enqueues on: the stream
    current where the pipeline is built (None off the card).  Every thread
    of the pipeline that puts work on the card enters it
    (:func:`stream_context`), so work handed from one thread to the next is
    ordered by the stream itself."""
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def stream_context(stream: Optional[torch.cuda.Stream]):
    """Make ``stream`` current in this thread (nothing for None)."""
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def on_device(x, device) -> torch.Tensor:
    """``x`` as a tensor on ``device``.

    An array (numpy or nested lists) is copied there.  A tensor must already
    be there: a frame on the card is never copied to the host behind the
    caller's back (it would run the plain path on the CPU instead of the
    kernels), and a host frame is never moved to the card unasked.
    """
    device = torch.device(device)
    if not isinstance(x, torch.Tensor):
        return torch.as_tensor(np.asarray(x), device=device)
    want = device
    if want.type == "cuda" and want.index is None and x.is_cuda:
        want = torch.device("cuda", torch.cuda.current_device())
    if x.device != want:
        raise ValueError(f"tensor is on {x.device}, but this pipeline runs on {device}; "
                         "move it explicitly or build the pipeline for that device")
    return x


class DeviceFile(torch.Tensor):
    """A compressed tile that stays on its device: a flat uint8 tensor that a
    consumer on the host reads as an array (``np.asarray`` copies it down
    once).  Work on the card needs no event of its own: the threads of a
    pipeline enqueue on its one stream (:func:`pipeline_stream`).
    Operations on it give plain tensors."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    def __array__(self, dtype=None, copy=None):
        arr = torch.Tensor.cpu(self).numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)


def host_bytes(tile) -> np.ndarray:
    """A tile's bytes as a flat host array: a tensor on the card is copied to
    the host here (one copy of the whole tile)."""
    if isinstance(tile, torch.Tensor):
        tile = tile.cpu().numpy()
    return np.asarray(tile, dtype=np.uint8).reshape(-1)
