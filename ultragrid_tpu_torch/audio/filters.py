"""Audio filters & mixer (ref: src/audio/filter/ + audio/mixer.cpp).

gain (volume/mute), delay, silence, channel_remap (--audio-channel-map),
conference mixer.

The port's copy of ``ultragrid_tpu/audio/filters.py``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame


class AudioFilter:
    def apply(self, frame: AudioFrame) -> Optional[AudioFrame]:
        raise NotImplementedError


class GainFilter(AudioFilter):
    """Volume scale in dB; also the keyboard-control mute/volume backend."""

    def __init__(self, gain_db: float = 0.0):
        self.gain_db = gain_db
        self.muted = False

    def apply(self, frame):
        if self.muted:
            scale = 0.0
        else:
            scale = 10.0 ** (self.gain_db / 20.0)
        if scale == 1.0:
            return frame
        samples = frame.samples_float() * scale
        out = AudioFrame.from_float(frame.desc, np.clip(samples, -1.0, 1.0))
        out.timestamp = frame.timestamp
        return out


class DelayFilter(AudioFilter):
    """Delay by N samples (ref: audio/filter/delay)."""

    def __init__(self, samples: int):
        self.samples = samples
        self._tail: Optional[np.ndarray] = None

    def apply(self, frame):
        x = frame.samples_float()
        ch, n = x.shape
        if self._tail is None:
            self._tail = np.zeros((ch, self.samples))
        joined = np.concatenate([self._tail, x], axis=1)
        out, self._tail = joined[:, :n], joined[:, n:]
        res = AudioFrame.from_float(frame.desc, out)
        res.timestamp = frame.timestamp
        return res


class SilenceFilter(AudioFilter):
    def apply(self, frame):
        z = np.zeros_like(frame.samples_float())
        out = AudioFrame.from_float(frame.desc, z)
        out.timestamp = frame.timestamp
        return out


class ChannelRemap(AudioFilter):
    """--audio-channel-map grammar ``src:dst[,src:dst...]`` (ref: audio.cpp)."""

    def __init__(self, spec: str):
        self.mapping: List[tuple] = []
        max_dst = 0
        for part in spec.split(","):
            s, _, d = part.partition(":")
            self.mapping.append((int(s), int(d)))
            max_dst = max(max_dst, int(d))
        self.out_channels = max_dst + 1

    def apply(self, frame):
        x = frame.samples_float()
        out = np.zeros((self.out_channels, x.shape[1]))
        for s, d in self.mapping:
            if s < x.shape[0]:
                out[d] += x[s]
        desc = frame.desc.with_(ch_count=self.out_channels)
        res = AudioFrame.from_float(desc, np.clip(out, -1.0, 1.0))
        res.timestamp = frame.timestamp
        return res


class DiscardFilter(AudioFilter):
    """Drops every frame (ref: audio/filter/discard.cpp — mutes a chain
    without reconfiguring downstream)."""

    def apply(self, frame):
        return None


class ControlPortStats(AudioFilter):
    """Reports per-channel RMS/peak through the control socket in the
    astat-parsable layout (ref: audio/filter/controlport_stats.cpp)."""

    def __init__(self, control=None, prefix: str = "AFILTER"):
        self.control = control
        self.prefix = prefix
        self.last_line: Optional[str] = None  # introspection/tests

    def apply(self, frame):
        from ultragrid_tpu_torch.audio.volume import format_stats_line

        self.last_line = format_stats_line(self.prefix, frame)
        if self.control is not None:
            self.control.report_stats(self.last_line)
        return frame


def make_audio_filter(spec: str, control=None) -> AudioFilter:
    """One ``<filter>[:<config>]`` element of the --audio-filter grammar
    (ref: main.cpp:271)."""
    name, _, cfg = spec.partition(":")
    if name == "gain":
        return GainFilter(float(cfg) if cfg else 0.0)
    if name == "delay":
        return DelayFilter(int(cfg) if cfg else 0)
    if name == "silence":
        return SilenceFilter()
    if name == "discard":
        return DiscardFilter()
    if name == "channel_remap":
        return ChannelRemap(cfg)
    if name == "controlport_stats":
        return ControlPortStats(control)
    raise ValueError(f"unknown audio filter {name!r} "
                     "(gain/delay/silence/discard/channel_remap/controlport_stats)")


def make_audio_filter_chain(spec: str, control=None) -> List[AudioFilter]:
    """``<filter>[:<config>][#<filter>...]`` -> filter list."""
    return [make_audio_filter(part, control) for part in spec.split("#") if part]


class AudioMixer:
    """Conference mixer: sums per-participant streams (ref: audio/mixer.cpp)."""

    def __init__(self, desc: AudioDesc):
        self.desc = desc
        self._pending: Dict[int, np.ndarray] = {}

    def add(self, ssrc: int, frame: AudioFrame) -> None:
        self._pending[ssrc] = frame.samples_float()

    def mix(self) -> AudioFrame:
        if not self._pending:
            return AudioFrame.from_float(self.desc, np.zeros((self.desc.ch_count, 0)))
        n = min(x.shape[1] for x in self._pending.values())
        acc = np.zeros((self.desc.ch_count, n))
        for x in self._pending.values():
            acc[: x.shape[0], :n] += x[:, :n]
        self._pending.clear()
        return AudioFrame.from_float(self.desc, np.clip(acc, -1.0, 1.0))
