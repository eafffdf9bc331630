"""Audio level measurement (RMS / peak in dBFS).

Parity with the reference's meters (ref: src/audio/utils.h calculate_rms /
calculate_rms2; stats line format consumed by tools/astat.cpp:83 —
``stats ARECV volrms0 <db> volpeak0 <db> ...``).

The port's copy of ``ultragrid_tpu/audio/volume.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from ultragrid_tpu_torch.audio.types import AudioFrame

MIN_DB = -999.0  # silence floor, matches astat's -INFINITY handling in spirit


def _samples(frame: AudioFrame, channel: int) -> np.ndarray:
    bps = frame.desc.bps
    raw = np.asarray(frame.channels[channel], np.uint8)
    if bps == 1:
        return (raw.astype(np.float64) - 128.0) / 128.0
    if bps == 2:
        return raw.view("<i2").astype(np.float64) / 32768.0
    if bps == 4:
        return raw.view("<i4").astype(np.float64) / 2147483648.0
    raise ValueError(f"unsupported bps {bps}")


def calculate_rms(frame: AudioFrame, channel: int) -> Tuple[float, float]:
    """Returns (rms, peak) as linear fractions of full scale
    (ref: calculate_rms, src/audio/utils.cpp)."""
    x = _samples(frame, channel)
    if x.size == 0:
        return 0.0, 0.0
    return float(np.sqrt((x * x).mean())), float(np.abs(x).max())


def to_dbfs(v: float) -> float:
    return 20.0 * math.log10(v) if v > 0 else MIN_DB


def format_stats_line(prefix: str, frame: AudioFrame) -> str:
    """Machine-readable stats line in the exact astat-parsable layout
    (ref: tools/astat.cpp:83)."""
    parts = [f"stats {prefix}"]
    for ch in range(frame.desc.ch_count):
        rms, peak = calculate_rms(frame, ch)
        parts.append(f"volrms{ch} {to_dbfs(rms):.4f} volpeak{ch} {to_dbfs(peak):.4f}")
    return " ".join(parts)


def parse_stats_line(line: str):
    """Inverse of format_stats_line: -> {ch: (rms_db, peak_db)} or None."""
    toks = line.split()
    if len(toks) < 2 or toks[0] != "stats":
        return None
    out = {}
    i = 2
    while i + 3 < len(toks):
        if toks[i].startswith("volrms") and toks[i + 2].startswith("volpeak"):
            ch = int(toks[i][6:])
            out[ch] = (float(toks[i + 1]), float(toks[i + 3]))
        i += 4
    return out or None
