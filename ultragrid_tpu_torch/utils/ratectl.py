"""Bitrate control for the OWN codec paths (JPEG / H.264).

The reference reaches rate-controlled video through libavcodec's
encoders (``-c libavcodec:bitrate=``, src/video_compress/libavcodec.cpp
:943-1003 sets bit_rate/rc_max_rate and per-codec tuning); its own
gpujpeg wrapper is quality-driven only.  Here the from-scratch codecs
accept a target too:

* ``-c jpeg:rate=10M`` (or ``-l 10M`` on the sender) drives the JPEG
  quality ladder so the measured stream rate tracks the target.
* ``-c h264:mode=inter:rate=4M`` adapts the fixed QP per GOP (intra
  modes: per frame) against the bits budget.

The port's copy of ``ultragrid_tpu/utils/ratectl.py`` (jax-free; copied,
not imported, so the port never runs the JAX package's ``__init__``).
Each JPEG quality has its own tables (quantisation folded into the
front-end matrix), so the controllers move along a bounded LADDER of
settings and the compress module keeps one encoder per rung.  Long-run
accuracy comes from dithering between adjacent rungs via a byte-debt
integrator rather than from a continuous knob.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional


def parse_rate(val: str) -> int:
    """``<num>[kKMG]`` -> bits per second (codec-config flavour of the
    ``-l`` grammar, without the pacing modifiers)."""
    val = (val or "").strip()
    mult = 1
    if val and val[-1] in "kKMG":
        mult = {"k": 1_000, "K": 1_000,
                "M": 1_000_000, "G": 1_000_000_000}[val[-1]]
        val = val[:-1]
    bps = int(float(val) * mult)
    if bps <= 0:
        raise ValueError("rate must be positive")
    return bps


class LadderRateController:
    """Pick the next rung of a quality/QP ladder from measured frame
    sizes so the long-run byte rate matches ``bitrate_bps``.

    A clamped integrator carries the running byte debt (actual −
    budget); one rung step per frame toward reducing the debt.  When
    the target sits between two rungs the controller dithers between
    them and the duty cycle makes the average land on the target —
    the same trick DC-balanced line codes use.
    """

    def __init__(self, bitrate_bps: int, fps: float,
                 ladder: List[int], start: int,
                 invert: bool = False):
        if fps <= 0:
            fps = 30.0
        self.target = bitrate_bps / 8.0 / fps
        self.ladder = list(ladder)
        self.invert = invert  # True when a HIGHER rung means FEWER bytes (QP)
        self.idx = min(range(len(self.ladder)),
                       key=lambda i: abs(self.ladder[i] - start))
        self.debt = 0.0
        self._frames = 0
        self._bytes = 0

    @property
    def value(self) -> int:
        return self.ladder[self.idx]

    def update(self, nbytes: int) -> int:
        """Record one encoded frame; return the rung for the NEXT frame."""
        self._frames += 1
        self._bytes += nbytes
        t = self.target
        self.debt = max(min(self.debt + nbytes - t, 8 * t), -8 * t)
        down = -1 if not self.invert else 1   # direction that SHRINKS frames
        if self.debt > 0.5 * t:
            ni = self.idx + down
        elif self.debt < -0.5 * t:
            ni = self.idx - down
        else:
            return self.ladder[self.idx]
        if 0 <= ni < len(self.ladder):
            self.idx = ni
        return self.ladder[self.idx]

    def measured_bps(self, fps: float) -> float:
        if not self._frames:
            return 0.0
        return self._bytes * 8.0 * fps / self._frames


class GopRateController:
    """Per-GOP QP adaptation for the own H.264 inter encoder.

    QP only changes at GOP boundaries (the next GOP opens with an IDR,
    so the encoder can be rebuilt without breaking the reference
    chain).  The classic +6 QP ≈ half-rate rule maps the measured
    GOP-bits error to a QP delta, clamped per adjustment; a carry
    accumulator keeps sub-QP precision so the average converges.
    """

    def __init__(self, bitrate_bps: int, fps: float, gop: int,
                 qp0: int, qp_min: int = 10, qp_max: int = 51):
        if fps <= 0:
            fps = 30.0
        self.target_gop = bitrate_bps / 8.0 * gop / fps
        self.qp = int(qp0)
        self.qp_min, self.qp_max = qp_min, qp_max
        self._gop_bytes = 0
        self._carry = 0.0
        self._frames = 0
        self._bytes = 0

    def frame(self, nbytes: int, gop_done: bool) -> int:
        """Record one frame; on ``gop_done`` adapt and return the QP for
        the NEXT GOP (otherwise the current QP)."""
        self._gop_bytes += nbytes
        self._frames += 1
        self._bytes += nbytes
        if not gop_done:
            return self.qp
        actual = max(self._gop_bytes, 1)
        self._gop_bytes = 0
        want = 6.0 * math.log2(actual / self.target_gop) + self._carry
        step = max(-4, min(4, int(round(want))))
        self._carry = want - step
        # carry is only meaningful while we can still move
        nqp = max(self.qp_min, min(self.qp_max, self.qp + step))
        if nqp == self.qp:
            self._carry = max(-1.0, min(1.0, self._carry))
        self.qp = nqp
        return self.qp

    def measured_bps(self, fps: float) -> float:
        if not self._frames:
            return 0.0
        return self._bytes * 8.0 * fps / self._frames


JPEG_QUALITY_LADDER: List[int] = list(range(10, 100, 5)) + [97]


def jpeg_controller(bitrate_bps: int, fps: float,
                    start_quality: int) -> LadderRateController:
    return LadderRateController(bitrate_bps, fps, JPEG_QUALITY_LADDER,
                                start_quality)


def h264_intra_controller(bitrate_bps: int, fps: float,
                          start_qp: int) -> LadderRateController:
    # QP ladder: higher rung = fewer bytes -> invert
    return LadderRateController(bitrate_bps, fps, list(range(10, 52)),
                                start_qp, invert=True)
