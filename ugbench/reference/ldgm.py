"""Plain NumPy LDGM (LDPC-staircase, RFC 5170) for the benchmark's check.

The parity-check matrix comes from the RFC's Park-Miller generator, so a
receiver built from the RFC rebuilds it from (k, m, c, seed) alone; the
parity of a frame's data symbols is the XOR of the symbols each row names,
accumulated down the staircase.  The wire buffer is the data part
([u32 length][video payload header][frame][zero pad]) and then the parity.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

VIDEO_HDR_LEN = 24
LEN_WORD = 4


def _pmms(seed: int):
    """Park-Miller minimal standard generator: rand(maxv) draws."""
    state = [seed]

    def rand(maxv: int) -> int:
        state[0] = (16807 * state[0]) % 0x7FFFFFFF
        return int(float(maxv) * float(state[0]) / float(0x7FFFFFFF))

    return rand


@lru_cache(maxsize=8)
def left_matrix(k: int, m: int, c: int, seed: int) -> np.ndarray:
    """The left part of the parity-check matrix, uint8 [m, k] (RFC 5170
    section 5.4: c ones per column, then every row given at least two)."""
    if not 0 < seed < 0x7FFFFFFF or c > m:
        raise ValueError(f"bad LDGM parameters k={k} m={m} c={c} seed={seed}")
    rand = _pmms(seed)
    mat = np.zeros((m, k), np.uint8)
    u = [h % m for h in range(c * k)]
    t = 0
    for j in range(k):
        for _ in range(c):
            i = t
            while i < c * k and mat[u[i], j]:
                i += 1
            if i < c * k:
                while True:
                    i = t + rand(c * k - t)
                    if not mat[u[i], j]:
                        break
                mat[u[i], j] = 1
                u[i] = u[t]
                t += 1
            else:
                while True:
                    i = rand(m)
                    if not mat[i, j]:
                        break
                mat[i, j] = 1
    for i in range(m):
        deg = int(mat[i].sum())
        if deg == 0:
            mat[i, rand(k)] = 1
            deg = 1
        if deg == 1:
            while True:
                j = rand(k)
                if not mat[i, j]:
                    break
            mat[i, j] = 1
    return mat


def parity(data: np.ndarray, k: int, m: int, c: int, seed: int) -> np.ndarray:
    """uint8 [m, ps] parity of the data part ``data`` (k * ps bytes)."""
    sym = np.asarray(data, np.uint8).reshape(k, -1)
    mat = left_matrix(k, m, c, seed)
    par = np.stack([np.bitwise_xor.reduce(sym[np.flatnonzero(row)], axis=0) for row in mat])
    return np.bitwise_xor.accumulate(par, axis=0)


def split_buffer(buf: np.ndarray, k: int, m: int):
    """(frame bytes, data part, parity part) of an LDGM wire buffer; raises
    where the buffer does not hold k + m equal symbols or its length word
    overruns the data part."""
    buf = np.asarray(buf, np.uint8).reshape(-1)
    if buf.size % (k + m):
        raise ValueError(f"buffer of {buf.size} bytes is not {k + m} equal symbols")
    ps = buf.size // (k + m)
    data, par = buf[: k * ps], buf[k * ps:]
    n = int(np.frombuffer(data[:LEN_WORD].tobytes(), "<u4")[0])
    if n < VIDEO_HDR_LEN or LEN_WORD + n > data.size:
        raise ValueError(f"length word {n} does not fit a data part of {data.size} bytes")
    payload = data[LEN_WORD: LEN_WORD + n]
    frame_len = int.from_bytes(payload[8:12].tobytes(), "big")
    frame = payload[VIDEO_HDR_LEN: VIDEO_HDR_LEN + frame_len]
    return frame, data, par
