"""Sample-rate conversion (ref: src/audio/resampler.cpp — speex/soxr backed).

Windowed-sinc polyphase resampler in numpy; quality comparable to the
reference's medium speex setting for the rational ratios used in practice
(44.1k <-> 48k etc.).

The port's copy of ``ultragrid_tpu/audio/resampler.py``.
"""

from __future__ import annotations

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame


@lru_cache(maxsize=16)
def _filter_bank(up: int, down: int, taps_per_phase: int = 24, beta: float = 8.6):
    """Kaiser-windowed sinc polyphase bank [up, taps_per_phase]."""
    ntaps = taps_per_phase * up
    cutoff = min(1.0 / up, 1.0 / down)
    n = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n) * np.kaiser(ntaps, beta) * up
    # pad & reshape into phases
    h = np.concatenate([h, np.zeros((-len(h)) % up)])
    return h.reshape(-1, up).T  # [up, ntaps//up]


def resample_channel(x: np.ndarray, up: int, down: int) -> np.ndarray:
    """Rational resample of a float signal."""
    if up == down:
        return x
    bank = _filter_bank(up, down)
    taps = bank.shape[1]
    half = taps // 2
    xp = np.pad(x, (half, half + taps))
    nout = (len(x) * up) // down
    out = np.empty(nout)
    # output sample j comes from input position j*down/up
    j = np.arange(nout)
    pos = j * down  # in units of 1/up input samples
    base = pos // up
    phase = pos % up
    # gather windows: [nout, taps]
    idx = base[:, None] + np.arange(taps)[None, :]
    windows = xp[idx]
    out = np.einsum("nt,nt->n", windows, bank[phase])
    return out


class Resampler:
    def __init__(self, to_rate: int):
        self.to_rate = to_rate

    def process(self, frame: AudioFrame) -> AudioFrame:
        if frame.desc.sample_rate == self.to_rate:
            return frame
        ratio = Fraction(self.to_rate, frame.desc.sample_rate)
        samples = frame.samples_float()
        out = np.stack([
            resample_channel(samples[c], ratio.numerator, ratio.denominator)
            for c in range(samples.shape[0])
        ])
        desc = frame.desc.with_(sample_rate=self.to_rate)
        res = AudioFrame.from_float(desc, np.clip(out, -1.0, 1.0))
        res.timestamp = frame.timestamp
        return res
