"""Plugin registry of the port (ref: REGISTER_MODULE, src/lib_common.h:158-176).

The port's copy of ``ultragrid_tpu/modules/registry.py``: modules register
at import time keyed by (library class, name) with an ABI version, and
``load_library`` looks them up like the reference's lib_common.  This is the
port's own table, so the port's modules register under the reference's
names without touching the JAX package's registry.
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional, Tuple

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("registry")


class LibraryClass(enum.Enum):
    """ref: enum library_class, src/lib_common.h:73-96."""

    VIDEO_CAPTURE = "video_capture"
    VIDEO_DISPLAY = "video_display"
    VIDEO_COMPRESS = "video_compress"
    VIDEO_DECOMPRESS = "video_decompress"
    CAPTURE_FILTER = "capture_filter"
    VO_POSTPROCESS = "vo_postprocess"
    AUDIO_CAPTURE = "audio_capture"
    AUDIO_PLAYBACK = "audio_playback"
    AUDIO_COMPRESS = "audio_compress"
    AUDIO_FILTER = "audio_filter"
    RXTX_PROTOCOL = "rxtx_protocol"
    FEC = "fec"


# ABI versions mirror the reference so the contract surface is explicit
ABI_VERSIONS = {
    LibraryClass.VIDEO_CAPTURE: 14,   # ref: src/video_capture.h:109
    LibraryClass.VIDEO_DISPLAY: 21,   # ref: src/video_display.h:149
    LibraryClass.VIDEO_COMPRESS: 14,  # ref: src/video_compress.h:71
    LibraryClass.VIDEO_DECOMPRESS: 6, # ref: src/video_decompress.h:42
    LibraryClass.CAPTURE_FILTER: 4,   # ref: src/capture_filter.h:41
    LibraryClass.VO_POSTPROCESS: 8,   # ref: src/vo_postprocess.h
}

_registry: Dict[Tuple[LibraryClass, str], Tuple[Any, int]] = {}


def register_module(name: str, cls: LibraryClass, info: Any, abi: Optional[int] = None):
    """Register a module implementation (decorator-friendly)."""
    abi = abi if abi is not None else ABI_VERSIONS.get(cls, 1)
    _registry[(cls, name)] = (info, abi)
    return info


def load_library(name: str, cls: LibraryClass, abi: Optional[int] = None) -> Optional[Any]:
    """ref: load_library, src/lib_common.cpp."""
    entry = _registry.get((cls, name))
    if entry is None:
        log.error(f"No such module: {cls.value}/{name}")
        return None
    info, mod_abi = entry
    if abi is not None and mod_abi != abi:
        log.error(f"ABI mismatch for {cls.value}/{name}: {mod_abi} != {abi}")
        return None
    return info


def list_modules(cls: LibraryClass) -> List[str]:
    return sorted(n for (c, n) in _registry if c == cls)
