"""Audio capture modules: testcard (sine), wav file, silence.

ref: src/audio/capture/testcard.c (1 kHz sine, 16-bit 48 kHz, NTSC-aware
sample patterns), wav.c.

The port's copy of ``ultragrid_tpu/audio/capture.py``.
"""

from __future__ import annotations

import math
import time
import wave
from typing import Optional

import numpy as np

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
from ultragrid_tpu_torch.modules.registry import LibraryClass, load_library, register_module

# ref: alen_pattern_2997/5994, src/video_capture/testcard.c:108-110
ALEN_PATTERNS = {
    29.97: [1602, 1601, 1602, 1601, 1602],
    59.94: [801, 801, 800, 801, 801],
}


# -a/--audio-capture-format overrides, applied by captures that synthesize
# their own format (ref: audio_capture_{bps,channels,sample_rate} globals,
# host.cpp:330-342)
_capture_format: dict = {}


def set_audio_capture_format(spec: str) -> None:
    """``{channels=<num>|bps=<bits>|sample_rate=<rate>}[:,...]``
    (ref: parse_audio_format, audio/utils.cpp:720-770)."""
    import re

    out = dict(_capture_format)
    for item in re.split("[:,]", spec):
        if not item:
            continue
        key, _, val = item.partition("=")
        if key and "channels".startswith(key):
            n = int(val)
            if not 1 <= n <= 64:
                raise ValueError(f"invalid channel count {n} (1-64)")
            out["ch_count"] = n
        elif key and "bps".startswith(key):
            bits = int(val)
            if bits % 8 or not 0 < bits <= 32:
                raise ValueError(f"bps must be a multiple of 8 in 8-32, got {bits}")
            out["bps"] = bits // 8
        elif key and "sample_rate".startswith(key):
            mult = 1000 if val.lower().endswith("k") else 1
            out["sample_rate"] = int(float(val.rstrip("kK")) * mult)
        else:
            raise ValueError(f"unknown audio format item {item!r}")
    _capture_format.clear()
    _capture_format.update(out)


def default_capture_desc() -> AudioDesc:
    """Defaults with any -a/--audio-capture-format overrides applied."""
    return AudioDesc(**{**dict(bps=2, sample_rate=48000, ch_count=2,
                               codec="PCM"), **_capture_format})


class AudioCapture:
    def __init__(self, cfg: str):
        self.cfg = cfg
        self.desc = default_capture_desc()

    def read(self, nsamples: int) -> Optional[AudioFrame]:
        raise NotImplementedError

    def done(self) -> None:
        pass


class TestcardAudioCapture(AudioCapture):
    """1 kHz sine on all channels (ref: testcard audio, DEFAULT_AUIDIO_FREQUENCY)."""

    def __init__(self, cfg: str = "", frequency: int = 1000, volume: float = 0.25):
        super().__init__(cfg)
        self.desc = default_capture_desc()
        self.frequency = frequency
        self.volume = volume
        for tok in filter(None, (cfg or "").split(":")):
            key, _, val = tok.partition("=")
            if key in ("rate", "sample_rate"):
                self.desc = self.desc.with_(sample_rate=int(val))
            elif key in ("frequency", "freq"):
                self.frequency = int(val)
            elif key == "channels":
                self.desc = self.desc.with_(ch_count=int(val))
            elif key == "volume":
                self.volume = float(val)
        self.pos = 0

    def read(self, nsamples: int) -> AudioFrame:
        t = (np.arange(nsamples) + self.pos) / self.desc.sample_rate
        self.pos += nsamples
        wavef = np.sin(2 * math.pi * self.frequency * t) * self.volume
        samples = np.tile(wavef, (self.desc.ch_count, 1))
        frame = AudioFrame.from_float(self.desc, samples)
        frame.timestamp = time.monotonic()
        return frame


class WavAudioCapture(AudioCapture):
    """Reads a WAV file as the audio source (ref: audio/capture/wav)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self._wav = wave.open(cfg, "rb")
        self.desc = AudioDesc(
            bps=self._wav.getsampwidth(),
            sample_rate=self._wav.getframerate(),
            ch_count=self._wav.getnchannels(),
            codec="PCM",
        )

    def read(self, nsamples: int) -> Optional[AudioFrame]:
        raw = self._wav.readframes(nsamples)
        if not raw:
            return None
        frame = AudioFrame.from_interleaved(self.desc, np.frombuffer(raw, np.uint8))
        frame.timestamp = time.monotonic()
        return frame

    def done(self) -> None:
        self._wav.close()


class SilenceAudioCapture(AudioCapture):
    def __init__(self, cfg: str = ""):
        super().__init__(cfg)
        self.desc = default_capture_desc()

    def read(self, nsamples: int) -> AudioFrame:
        chans = [np.zeros(nsamples * self.desc.bps, np.uint8) for _ in range(self.desc.ch_count)]
        return AudioFrame(self.desc, chans)


register_module("testcard", LibraryClass.AUDIO_CAPTURE, TestcardAudioCapture)
register_module("wav", LibraryClass.AUDIO_CAPTURE, WavAudioCapture)
register_module("none", LibraryClass.AUDIO_CAPTURE, SilenceAudioCapture)


def initialize_audio_capture(spec: str) -> AudioCapture:
    name, _, cfg = spec.partition(":")
    cls = load_library(name, LibraryClass.AUDIO_CAPTURE)
    if cls is None:
        raise ValueError(f"unknown audio capture {name!r}")
    return cls(cfg)


# the sibling devices subclass AudioCapture, so they register once it exists
# (the modules package imports this module by name only, never a name from it)
import ultragrid_tpu_torch.audio.aes67  # noqa: E402,F401
import ultragrid_tpu_torch.audio.alsa  # noqa: E402,F401
import ultragrid_tpu_torch.audio.midi_synth  # noqa: E402,F401
