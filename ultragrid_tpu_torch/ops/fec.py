"""LDGM forward error correction on tensors (the port of ``ultragrid_tpu/ops/fec.py``).

The sender's device half: the RFC 5170 LDPC-staircase parity-check matrix
(same Park-Miller PRNG as the reference, so the same matrix bit for bit) and
parity = mask @ data over GF(2) with the staircase accumulation, read from
the parts of the sender's container.  On CUDA tensors the parity is kernel
K2 (``csrc/gf2_parity.cu``); on CPU tensors it is the plain version.  Decoding and
Reed-Solomon are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ultragrid_tpu_torch import _build

LAUNCHES = _build.LaunchCounter("gf2_parity")

# ---------------------------------------------------------------------------
# Park-Miller PRNG + RFC 5170 LDPC-staircase matrix (bit-exact w/ reference)
# ---------------------------------------------------------------------------


class RandPmms:
    """Park-Miller minimal standard PRNG (ref: ldgm/matrix-gen/rand_pmms.h)."""

    def __init__(self, seed: int):
        if not 0 < seed < 0x7FFFFFFF:
            raise ValueError(f"seed {seed} out of range")
        self.val = seed

    def nextrand(self) -> int:
        self.val = (16807 * self.val) % 0x7FFFFFFF
        return self.val

    def rand(self, maxv: int) -> int:
        return int(float(maxv) * float(self.nextrand()) / float(0x7FFFFFFF))


@lru_cache(maxsize=16)
def build_ldgm_matrix(k: int, m: int, c: int, seed: int = 1) -> np.ndarray:
    """Left parity-check matrix [m, k] uint8 (ref: left_matrix_init,
    ldgm/matrix-gen/ldpc-matrix.cpp:99-160; the staircase part is implicit
    in the parity accumulation)."""
    # c ones per column must fit in m rows, or the rejection sampler below
    # never terminates
    if c > m:
        raise ValueError(f"LDGM c={c} must be <= m={m}")
    matrix = np.zeros((m, k), dtype=np.uint8)
    rng = RandPmms(seed)
    n = k + m
    u = [(h % (n - k)) for h in range(c * k)]
    t = 0
    for j in range(k):
        for _ in range(c):
            i = t
            while i < c * k and matrix[u[i]][j]:
                i += 1
            if i < c * k:
                while True:
                    i = t + rng.rand(c * k - t)
                    if not matrix[u[i]][j]:
                        break
                matrix[u[i]][j] = 1
                u[i] = u[t]
                t += 1
            else:
                while True:
                    i = rng.rand(n - k)
                    if not matrix[i][j]:
                        break
                matrix[i][j] = 1
    for i in range(m):
        deg = int(matrix[i].sum())
        if deg == 0:
            j = rng.rand(k)
            matrix[i][j] = 1
            deg = 1
        if deg == 1:
            while True:
                j = rng.rand(k)
                if not matrix[i][j]:
                    break
            matrix[i][j] = 1
    return matrix


# ---------------------------------------------------------------------------
# GF(2) parity
# ---------------------------------------------------------------------------


def _xor_rows(data: torch.Tensor, members) -> torch.Tensor:
    """XOR of the given rows of ``data`` (a balanced tree: log2 passes)."""
    if len(members) == 0:
        return data.new_zeros(data.shape[1:])
    x = data[torch.as_tensor(np.asarray(members, np.int64), device=data.device)]
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
        x = x[0::2] ^ x[1::2]
    return x[0]


def apply_staircase(par: torch.Tensor) -> torch.Tensor:
    """Cumulative XOR down the parity rows (row i ^= row i-1 ^ ...), by
    log-shift doubling as in the reference (models/encode.py:252-256)."""
    m = par.shape[0]
    k = 1
    while k < m:
        par = par ^ torch.cat([par.new_zeros((k,) + tuple(par.shape[1:])), par[: m - k]])
        k *= 2
    return par


def gf2_matmul(mask, data_u8: torch.Tensor, staircase: bool = False) -> torch.Tensor:
    """Parity symbols = mask @ data over GF(2) (reference ops/fec.py:211).

    mask: [M, K] 0/1 (array or tensor); data: [K, ps] uint8 -> [M, ps]
    uint8.  With ``staircase``, parity m also XORs parity m-1.  One XOR
    reduction per parity row: no [M, K, ps] broadcast, which would take
    about 0.9 GB at 8K.
    """
    mask_np = np.asarray(mask.cpu() if isinstance(mask, torch.Tensor) else mask) != 0
    par = torch.stack([_xor_rows(data_u8, np.nonzero(row)[0]) for row in mask_np])
    return apply_staircase(par) if staircase else par


class Gf2Parity:
    """LDGM parity of a static mask over u32 words (reference
    ``make_gf2_parity_pallas``, ops/fec.py:141, with the container assembly
    and the staircase of models/encode.py around it).

    The container is given as up to six parts: part p, flattened, fills
    ``row_counts[p]`` rows of ``psw`` words, zero past its own
    ``part_words[p]`` words (by default one part, the whole ``[rows, psw]``
    container).  ``par(*parts)`` returns int32 [m, psw]: the XOR of the
    container rows each mask row selects and of all parity rows before it
    (the staircase).  On CUDA tensors it launches K2, which never
    builds the container; on CPU tensors it runs :meth:`plain`.
    """

    def __init__(self, mask_rows, psw: int, part_words=None):
        mask_np = np.asarray(mask_rows) != 0
        self.m, self.rows = mask_np.shape
        self.psw = psw
        self.part_words = [self.rows * psw] if part_words is None else [int(w) for w in part_words]
        self.row_counts = [-(-w // psw) for w in self.part_words]
        if not 1 <= len(self.part_words) <= 6 or sum(self.row_counts) != self.rows:
            raise ValueError(f"{len(self.part_words)} parts of {self.row_counts} rows do not fill "
                             f"the mask's {self.rows} columns")
        self.row0 = np.concatenate([[0], np.cumsum(self.row_counts)]).astype(np.int32)
        self.members = [np.nonzero(r)[0].astype(np.int32) for r in mask_np]
        self.row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in self.members])]).astype(np.int32)
        self.cols = (np.concatenate(self.members) if self.members else np.zeros(0)).astype(np.int32)
        self._csr = {}  # torch.device -> (row_ptr, cols) on the device

    def _check(self, parts) -> None:
        if len(parts) != len(self.part_words):
            raise ValueError(f"parity input: expected {len(self.part_words)} parts, got {len(parts)}")
        dev = parts[0].device
        for p, w in zip(parts, self.part_words):
            if p.dtype != torch.int32 or p.numel() != w or p.device != dev:
                raise ValueError(f"parity input: expected int32 parts of {self.part_words} words on "
                                 f"{dev}, got {p.dtype} {tuple(p.shape)} on {p.device}")

    def container(self, parts) -> torch.Tensor:
        """The parts -> the [rows, psw] int32 container, each part
        zero-padded to its own rows."""
        out = torch.zeros(self.rows * self.psw, dtype=torch.int32, device=parts[0].device)
        for p, r0 in zip(parts, self.row0):
            flat = p.reshape(-1)
            out[int(r0) * self.psw: int(r0) * self.psw + flat.numel()] = flat
        return out.reshape(self.rows, self.psw)

    def plain(self, *parts) -> torch.Tensor:
        """Plain PyTorch version of K2, on any device."""
        self._check(parts)
        data = self.container(parts)
        return apply_staircase(torch.stack([_xor_rows(data, r) for r in self.members]))

    def __call__(self, *parts) -> torch.Tensor:
        if parts[0].is_cuda:
            return self.launch(*parts)
        if parts[0].device.type == "cpu":
            return self.plain(*parts)
        raise ValueError(f"gf2 parity: unsupported device {parts[0].device}")

    def launch(self, *parts) -> torch.Tensor:
        """Kernel K2 on CUDA tensors."""
        self._check(parts)
        if not all(p.is_cuda and p.is_contiguous() for p in parts):
            raise ValueError("K2 needs contiguous CUDA tensors")
        dev = parts[0].device
        csr = self._csr.get(dev)
        if csr is None:
            csr = self._csr[dev] = (torch.as_tensor(self.row_ptr, device=dev),
                                    torch.as_tensor(self.cols, device=dev))
        out = torch.empty(self.m, self.psw, dtype=torch.int32, device=dev)
        ptrs = np.array([p.data_ptr() for p in parts], np.int64)
        words = np.array(self.part_words, np.int64)
        lib = _build.kernels_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ug_gf2_parity(ptrs.ctypes.data, words.ctypes.data, self.row0.ctypes.data,
                                    len(parts), self.psw, csr[0].data_ptr(), csr[1].data_ptr(),
                                    self.m, len(self.cols), out.data_ptr(), stream)
        _build.check(err, "gf2_parity launch")
        LAUNCHES.count += 1
        return out


def make_gf2_parity(mask_rows, psw: int, part_words=None) -> Gf2Parity:
    """K2 plus its plain version for one session's mask (columns = container
    rows)."""
    return Gf2Parity(mask_rows, psw, part_words)
