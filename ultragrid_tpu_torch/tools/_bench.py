"""What the port's bench tools share: the device argument and timing.

A tool runs on the card unless it is given ``--device cpu`` (or another torch
device); without a card it raises, never falling back.  Device time is read
by CUDA events around back-to-back launches on the card, and by the host
clock on the CPU, where nothing is queued.
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch

from ultragrid_tpu_torch.device import get_device


def device_arg(argv: List[str]) -> Tuple[List[str], torch.device]:
    """(argv without ``--device NAME``, the device it names; the card by
    default, raising without one)."""
    rest = list(argv)
    name = "cuda"
    if "--device" in rest:
        i = rest.index("--device")
        if i + 1 >= len(rest):
            raise SystemExit("--device needs a value, e.g. --device cpu")
        name = rest[i + 1]
        del rest[i:i + 2]
    return rest, get_device(name)


def sync(device: torch.device) -> None:
    """Wait for the device's queue (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def per_call_ms(fn: Callable[[], object], device: torch.device, iters: int) -> float:
    """ms per call over ``iters`` back-to-back calls of a warm ``fn``."""
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters
