"""--capabilities: machine-readable module/device inventory of the port.

Port of ``ultragrid_tpu/utils/capabilities.py`` (ref: src/host.cpp
capabilities printing — the Qt GUI spawns ``uv --capabilities`` and parses
the JSON to populate its device/codec pickers), over the port's registry
and conversion pairs; the devices are the CUDA cards torch sees.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import torch

import ultragrid_tpu_torch
import ultragrid_tpu_torch.modules  # noqa: F401  (registers the built-in modules)
from ultragrid_tpu_torch.modules.registry import LibraryClass, list_modules
from ultragrid_tpu_torch.ops.pixfmt import conversion_pairs
from ultragrid_tpu_torch.types import CODEC_INFO, Codec


def get_capabilities() -> Dict[str, Any]:
    caps: Dict[str, Any] = {
        "version": ultragrid_tpu_torch.__version__,
        "backend": "torch-cuda",
    }
    for cls in LibraryClass:
        mods = list_modules(cls)
        if mods:
            caps[cls.value] = mods
    caps["codecs"] = [info.name for c, info in CODEC_INFO.items() if c != Codec.NONE]
    caps["conversions"] = [f"{a.name}->{b.name}" for a, b in conversion_pairs()]
    caps["devices"] = [f"cuda:{i} {torch.cuda.get_device_name(i)}" for i in range(torch.cuda.device_count())]
    return caps


def print_capabilities() -> None:
    print(json.dumps(get_capabilities(), indent=2))
