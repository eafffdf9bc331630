"""Audio frame types (ref: src/audio/types.h:100-226).

The port's copy of ``ultragrid_tpu/audio/types.py``.

The reference keeps both interleaved ``audio_frame`` and per-channel
``audio_frame2``; here one class stores per-channel byte buffers (the
network-facing layout) with interleave/deinterleave helpers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

# wire codec tags (ref: audio_codec_info[], src/audio/codec.c:63-75)
AUDIO_TAGS = {
    "PCM": 0x0001,
    "alaw": 0x0006,
    "ulaw": 0x0007,
    "speex": 0xA109,
    "Opus": 0x7375704F,
    "G722": 0x028F,
    "MP3": 0x0055,
    "AAC": 0x00FF,
    "FLAC": 0xF1AC,
}
TAG_TO_CODEC = {v: k for k, v in AUDIO_TAGS.items()}


@dataclasses.dataclass(frozen=True)
class AudioDesc:
    """ref: struct audio_desc (bps bytes/sample, sample_rate, ch_count, codec)."""

    bps: int = 2
    sample_rate: int = 48000
    ch_count: int = 2
    codec: str = "PCM"

    def with_(self, **kw):
        return dataclasses.replace(self, **kw)


class AudioFrame:
    """Per-channel audio data (ref: audio_frame2, src/audio/types.h:149-226)."""

    def __init__(self, desc: AudioDesc, channels: Optional[List[np.ndarray]] = None):
        self.desc = desc
        self.channels: List[np.ndarray] = channels if channels is not None else [
            np.zeros(0, np.uint8) for _ in range(desc.ch_count)
        ]
        self.timestamp: float = -1.0

    @property
    def sample_count(self) -> int:
        if not self.channels or self.desc.bps == 0:
            return 0
        return len(self.channels[0]) // self.desc.bps

    @staticmethod
    def from_interleaved(desc: AudioDesc, data: np.ndarray) -> "AudioFrame":
        """Interleaved bytes -> per-channel (ref: audio_frame2::init + append)."""
        data = np.asarray(data, np.uint8).reshape(-1)
        bps, ch = desc.bps, desc.ch_count
        nsamples = data.size // (bps * ch)
        x = data[: nsamples * bps * ch].reshape(nsamples, ch, bps)
        return AudioFrame(desc, [np.ascontiguousarray(x[:, c, :]).reshape(-1) for c in range(ch)])

    def to_interleaved(self) -> np.ndarray:
        bps, ch = self.desc.bps, self.desc.ch_count
        n = self.sample_count
        out = np.zeros((n, ch, bps), np.uint8)
        for c in range(ch):
            out[:, c, :] = self.channels[c][: n * bps].reshape(n, bps)
        return out.reshape(-1)

    def samples_float(self) -> np.ndarray:
        """[ch, n] float in [-1, 1] (PCM signed little-endian)."""
        bps = self.desc.bps
        dt = {1: np.int8, 2: "<i2", 4: "<i4"}[bps]
        scale = float(1 << (bps * 8 - 1))
        return np.stack([
            np.frombuffer(c.tobytes(), dtype=dt).astype(np.float64) / scale
            for c in self.channels
        ])

    @staticmethod
    def from_float(desc: AudioDesc, samples: np.ndarray) -> "AudioFrame":
        """[ch, n] float in [-1, 1] -> PCM frame."""
        bps = desc.bps
        dt = {1: np.int8, 2: "<i2", 4: "<i4"}[bps]
        lim = (1 << (bps * 8 - 1)) - 1
        chans = []
        for c in range(desc.ch_count):
            x = np.clip(np.round(samples[c] * (lim + 1)), -lim - 1, lim).astype(dt)
            chans.append(np.frombuffer(x.tobytes(), np.uint8).copy())
        return AudioFrame(desc, chans)
