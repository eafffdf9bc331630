"""Acoustic echo cancellation.

Parity with the reference's speex-based canceller (ref: src/audio/echo.cpp —
echo_cancellation_init / echo_play / echo_cancel, 512-sample frames, default
filter length 24000 samples, far-end ring buffer with prefill alignment).

The algorithm here is a partitioned-block frequency-domain adaptive filter
(MDF/PBFDAF — the same family speex_echo implements): the echo path is
modelled as K partitions of 512 taps, adapted per block with NLMS in the
frequency domain.  Pure numpy; one 1024-point FFT triple per 512-sample
block, independent of filter length.

The port's copy of ``ultragrid_tpu/audio/echo.py``.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from ultragrid_tpu_torch.audio.types import AudioFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("echo")

SAMPLES_PER_FRAME = 512  # ref: echo.cpp:55
DEFAULT_FILTER_LENGTH = 48 * 500  # samples, ref: echo.cpp:56


class EchoCanceller:
    """Mono 16-bit AEC with the reference's play/cancel streaming interface."""

    def __init__(self, filter_length: int = DEFAULT_FILTER_LENGTH, mu: float = 0.5):
        self.n = SAMPLES_PER_FRAME
        self.k = max(1, (filter_length + self.n - 1) // self.n)
        self.mu = mu
        m = 2 * self.n
        self._w = np.zeros((self.k, m), np.complex128)  # partition weights
        self._x_hist = np.zeros((self.k, m), np.complex128)  # far spectra
        self._last_far = np.zeros(self.n, np.float64)
        self._far_buf = np.zeros(0, np.float64)  # far-end ring (samples)
        self._near_buf = np.zeros(0, np.float64)
        self._out = deque()
        self._eps = 1e-6
        self._rate: Optional[int] = None

    # -- streaming interface (ref: echo_play / echo_cancel) ---------------

    def play(self, frame: AudioFrame) -> None:
        """Queue far-end (playback) samples."""
        if frame.desc.ch_count != 1:
            log.warning("echo cancellation requires mono audio; passing through")
            return
        far = self._to_float(frame)
        self._far_buf = np.concatenate([self._far_buf, far])

    def cancel(self, frame: AudioFrame) -> AudioFrame:
        """Cancel queued far-end echo from a captured (near-end) frame."""
        if frame.desc.ch_count != 1:
            return frame
        self._rate = frame.desc.sample_rate
        near = self._to_float(frame)
        self._near_buf = np.concatenate([self._near_buf, near])
        out = []
        while self._near_buf.size >= self.n:
            nearb = self._near_buf[: self.n]
            self._near_buf = self._near_buf[self.n :]
            if self._far_buf.size >= self.n:
                farb = self._far_buf[: self.n]
                self._far_buf = self._far_buf[self.n :]
            else:
                farb = np.zeros(self.n)
            out.append(self._process_block(farb, nearb))
        if out:
            cleaned = np.concatenate(out)
        else:
            cleaned = np.zeros(0)
        # keep a latency-free tail: whatever did not fill a block passes
        # through unprocessed on the next call; emit what we have
        data = np.frombuffer(
            np.clip(cleaned, -32768, 32767).astype("<i2").tobytes(), np.uint8
        )
        out_frame = AudioFrame(frame.desc.with_(bps=2), [data])
        out_frame.timestamp = frame.timestamp
        return out_frame

    # -- core --------------------------------------------------------------

    def _process_block(self, far: np.ndarray, near: np.ndarray) -> np.ndarray:
        m = 2 * self.n
        x = np.concatenate([self._last_far, far])
        self._last_far = far.copy()
        xf = np.fft.fft(x, m)
        self._x_hist = np.roll(self._x_hist, 1, axis=0)
        self._x_hist[0] = xf
        # echo estimate: overlap-save across partitions
        yf = np.sum(self._w * self._x_hist, axis=0)
        y = np.fft.ifft(yf).real[self.n :]
        e = near - y
        # adapt: normalized LMS in frequency domain with gradient constraint
        ef = np.fft.fft(np.concatenate([np.zeros(self.n), e]), m)
        p = np.sum(np.abs(self._x_hist) ** 2, axis=0) + self._eps
        grad = np.conj(self._x_hist) * (self.mu * ef / p)[None, :]
        # constrain each partition's update to causal N-tap form
        gt = np.fft.ifft(grad, axis=1).real
        gt[:, self.n :] = 0.0
        self._w += np.fft.fft(gt, axis=1)
        return e

    @staticmethod
    def _to_float(frame: AudioFrame) -> np.ndarray:
        bps = frame.desc.bps
        raw = np.asarray(frame.channels[0], np.uint8)
        if bps == 2:
            return raw.view("<i2").astype(np.float64)
        if bps == 1:
            return (raw.astype(np.float64) - 128.0) * 256.0
        if bps == 4:
            return raw.view("<i4").astype(np.float64) / 65536.0
        raise ValueError(f"unsupported bps {bps}")
