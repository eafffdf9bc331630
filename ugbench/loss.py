"""Seeded loss of whole data packets, applied to the sender's batches.

Frame n (in the order the sender sends) loses ``per_frame`` of its packets
that carry only data symbols, chosen by a generator seeded with (seed, n):
the same seed drops the same packets of the same frames in every run.
"""

from __future__ import annotations

import numpy as np


class DataPacketLoss:
    def __init__(self, per_frame: int, seed: int, k: int, m: int):
        self.per_frame = per_frame
        self.seed = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
        self.k, self.m = k, m
        self.frames = 0
        self.dropped = 0

    def __call__(self, hdrs, data, offsets, sizes):
        """(headers, offsets, sizes) of the packets that go out."""
        n = self.frames
        self.frames += 1
        if not self.per_frame:
            return hdrs, offsets, sizes
        data_end = np.asarray(data).size * self.k // (self.k + self.m)
        cand = np.flatnonzero(offsets + sizes <= data_end)
        rng = np.random.default_rng(self.seed + [n])
        lost = rng.choice(cand, min(self.per_frame, cand.size), replace=False)
        keep = np.setdiff1d(np.arange(sizes.size), lost)
        self.dropped += int(lost.size)
        return hdrs[keep], offsets[keep], sizes[keep]
