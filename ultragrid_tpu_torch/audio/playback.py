"""Audio playback modules: dummy (stats), wav writer.

ref: src/audio/playback/ (none/dummy + file writers; export writes sound.wav,
src/export.c).

The port's copy of ``ultragrid_tpu/audio/playback.py``.
"""

from __future__ import annotations

import time
import wave
from typing import Optional

import numpy as np

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
from ultragrid_tpu_torch.modules.registry import LibraryClass, load_library, register_module
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("aplay")


class AudioPlayback:
    def __init__(self, cfg: str):
        self.cfg = cfg
        self.desc: Optional[AudioDesc] = None
        self.samples_played = 0

    def reconfigure(self, desc: AudioDesc) -> bool:
        self.desc = desc
        return True

    def put_frame(self, frame: Optional[AudioFrame]) -> None:
        if frame is None:
            return
        self.samples_played += frame.sample_count

    def done(self) -> None:
        pass


class DummyAudioPlayback(AudioPlayback):
    pass


class WavAudioPlayback(AudioPlayback):
    """Writes received audio to a WAV file."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.path = cfg or "sound.wav"
        self._wav = None

    def reconfigure(self, desc: AudioDesc) -> bool:
        self.desc = desc
        if self._wav is not None:
            self._wav.close()
        self._wav = wave.open(self.path, "wb")
        self._wav.setnchannels(desc.ch_count)
        self._wav.setsampwidth(desc.bps)
        self._wav.setframerate(desc.sample_rate)
        return True

    def put_frame(self, frame: Optional[AudioFrame]) -> None:
        if frame is None:
            return
        super().put_frame(frame)
        if self._wav is not None:
            self._wav.writeframes(frame.to_interleaved().tobytes())

    def done(self) -> None:
        if self._wav is not None:
            self._wav.close()


register_module("dummy", LibraryClass.AUDIO_PLAYBACK, DummyAudioPlayback)
register_module("none", LibraryClass.AUDIO_PLAYBACK, DummyAudioPlayback)
register_module("wav", LibraryClass.AUDIO_PLAYBACK, WavAudioPlayback)


def initialize_audio_playback(spec: str) -> AudioPlayback:
    import ultragrid_tpu_torch.audio.alsa  # noqa: F401 - self-registers

    name, _, cfg = spec.partition(":")
    cls = load_library(name, LibraryClass.AUDIO_PLAYBACK)
    if cls is None:
        raise ValueError(f"unknown audio playback {name!r}")
    return cls(cfg)
