"""Forward error correction on tensors (the port of ``ultragrid_tpu/ops/fec.py``).

LDGM (LDPC-staircase): the RFC 5170 parity-check matrix (same Park-Miller
PRNG as the reference, so the same matrix bit for bit), the sender's parity
= mask @ data over GF(2) with the staircase accumulation, the wire layout of
:class:`LdgmSession` (host C encoder ``native/ldgm_xor.c``, shared with the
reference) and the erasure peel, on the host and on tensors.  On CUDA
tensors the parity and the peel's row XORs are kernel K2
(``csrc/gf2_parity.cu``), with the staircase on and off; on CPU tensors they
are its plain version.

Reed-Solomon over GF(256) (zfec's construction): each coefficient is an 8x8
GF(2) bit matrix, so the encode is one 0/1 float32 product (exact: sums are
at most ``8 k``), on the card ``torch.matmul`` with TF32 off; the decode is
host Gaussian elimination.  :func:`fec_from_spec` parses the ``-f`` grammar.
"""

from __future__ import annotations

import copy
import dataclasses
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch import _build, native
from ultragrid_tpu_torch.device import get_device
from ultragrid_tpu_torch.utils import profiler

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
    container rows each mask row selects and, with ``staircase``, of all
    parity rows before it.  With ``frames`` = B > 1 each part holds B
    frames' parts back to back (``B * part_words[p]`` words, as the batched
    sender's K1 output) and ``par`` returns [B, m, psw], one parity per
    frame.  On CUDA tensors it launches K2 (one launch for all B frames),
    which never builds the container; on CPU tensors it runs :meth:`plain`.
    """

    def __init__(self, mask_rows, psw: int, part_words=None, staircase: bool = True, frames: int = 1):
        mask_np = np.asarray(mask_rows) != 0
        self.m, self.rows = mask_np.shape
        self.psw = psw
        self.staircase = staircase
        self.frames = int(frames)
        self.part_words = [self.rows * psw] if part_words is None else [int(w) for w in part_words]
        self.row_counts = [-(-w // psw) for w in self.part_words]
        if not 1 <= len(self.part_words) <= 6 or sum(self.row_counts) != self.rows:
            raise ValueError(f"{len(self.part_words)} parts of {self.row_counts} rows do not fill "
                             f"the mask's {self.rows} columns")
        if not 1 <= self.frames <= 65535:
            raise ValueError(f"frame count {self.frames} out of range")
        self.row0 = np.concatenate([[0], np.cumsum(self.row_counts)]).astype(np.int32)
        self.members = [np.nonzero(r)[0].astype(np.int32) for r in mask_np]
        self.row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in self.members])]).astype(np.int32)
        self.cols = (np.concatenate(self.members) if self.members else np.zeros(0)).astype(np.int32)
        self._csr = {}  # torch.device -> (row_ptr, cols) on the device

    def with_width(self, psw: int) -> "Gf2Parity":
        """This one-part, one-frame parity over rows of ``psw`` words: the
        member lists and their copies on each device are shared, so a new
        symbol width (a live sender's, each frame) costs no upload."""
        if len(self.part_words) != 1 or self.frames != 1:
            raise ValueError("with_width: a one-part, one-frame parity only")
        par = copy.copy(self)
        par.psw, par.part_words = psw, [self.rows * psw]
        return par

    def _check(self, parts) -> None:
        if len(parts) != len(self.part_words):
            raise ValueError(f"parity input: expected {len(self.part_words)} parts, got {len(parts)}")
        dev = parts[0].device
        for p, w in zip(parts, self.part_words):
            if p.dtype != torch.int32 or p.numel() != self.frames * w or p.device != dev:
                raise ValueError(f"parity input: expected int32 parts of {self.frames} x {self.part_words} "
                                 f"words on {dev}, got {p.dtype} {tuple(p.shape)} on {p.device}")

    def container(self, parts) -> torch.Tensor:
        """One frame's parts -> the [rows, psw] int32 container, each part
        zero-padded to its own rows."""
        out = torch.zeros(self.rows * self.psw, dtype=torch.int32, device=parts[0].device)
        for p, r0 in zip(parts, self.row0):
            flat = p.reshape(-1)
            out[int(r0) * self.psw: int(r0) * self.psw + flat.numel()] = flat
        return out.reshape(self.rows, self.psw)

    def _plain_frame(self, parts) -> torch.Tensor:
        data = self.container(parts)
        par = torch.stack([_xor_rows(data, r) for r in self.members])
        return apply_staircase(par) if self.staircase else par

    def plain(self, *parts) -> torch.Tensor:
        """Plain PyTorch version of K2, on any device: one frame at a time."""
        self._check(parts)
        if self.frames == 1:
            return self._plain_frame(parts)
        flat = [p.reshape(-1) for p in parts]
        return torch.stack([self._plain_frame([p[f * w: (f + 1) * w] for p, w in zip(flat, self.part_words)])
                            for f in range(self.frames)])

    def __call__(self, *parts) -> torch.Tensor:
        if parts[0].is_cuda:
            return self.launch(*parts)
        if parts[0].device.type == "cpu":
            return self.plain(*parts)
        raise ValueError(f"gf2 parity: unsupported device {parts[0].device}")

    def launch(self, *parts, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Kernel K2 on CUDA tensors: one launch for all frames, into
        ``out`` where given (contiguous int32 of the parity's shape on the
        parts' device, e.g. the parity rows of a container)."""
        self._check(parts)
        if not all(p.is_cuda and p.is_contiguous() for p in parts):
            raise ValueError("K2 needs contiguous CUDA tensors")
        dev = parts[0].device
        csr = self._csr.get(dev)
        if csr is None:
            csr = self._csr[dev] = (torch.as_tensor(self.row_ptr, device=dev),
                                    torch.as_tensor(self.cols, device=dev))
        shape = (self.m, self.psw) if self.frames == 1 else (self.frames, self.m, self.psw)
        if out is None:
            out = torch.empty(shape, dtype=torch.int32, device=dev)
        elif out.dtype != torch.int32 or tuple(out.shape) != shape or out.device != dev or not out.is_contiguous():
            raise ValueError(f"K2 output: expected contiguous int32 {shape} on {dev}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}")
        ptrs = np.array([p.data_ptr() for p in parts], np.int64)
        words = np.array(self.part_words, np.int64)
        lib = _build.kernels_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ug_gf2_parity(ptrs.ctypes.data, words.ctypes.data, self.row0.ctypes.data,
                                    len(parts), self.frames, self.psw,
                                    csr[0].data_ptr(), csr[1].data_ptr(), self.m, len(self.cols),
                                    int(self.staircase), out.data_ptr(), stream)
        _build.check(err, "gf2_parity launch")
        LAUNCHES.count += 1
        return out


def make_gf2_parity(mask_rows, psw: int, part_words=None, frames: int = 1) -> Gf2Parity:
    """K2 plus its plain version for one session's mask (columns = container
    rows)."""
    return Gf2Parity(mask_rows, psw, part_words, frames=frames)


def _tensor(x, device) -> torch.Tensor:
    """A tensor as it is, on its own device; an array copied to ``device``
    (the card unless the caller names another)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=get_device(device))


def symbol_words(sym: torch.Tensor) -> torch.Tensor:
    """uint8 [R, ps] symbols -> int32 [R, ceil(ps / 4)] words, zero-padded
    past ``ps`` (zeros XOR to nothing, so a parity of the words is exact)."""
    if sym.dtype != torch.uint8 or sym.dim() != 2:
        raise ValueError(f"symbols must be uint8 [rows, ps], got {sym.dtype} {tuple(sym.shape)}")
    pad = -sym.shape[1] % 4
    if pad:
        sym = torch.nn.functional.pad(sym, (0, pad))
    return sym.contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# GF(2) bit-plane product (Reed-Solomon)
# ---------------------------------------------------------------------------


def _unpack_bits(data_u8: torch.Tensor) -> torch.Tensor:
    """[K, ps] uint8 -> [K, ps*8] float32 bits (MSB first within byte)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=data_u8.device)
    bits = (data_u8[..., None] >> shifts) & 1
    return bits.reshape(data_u8.shape[0], -1).to(torch.float32)


def _pack_bits(bits_i32: torch.Tensor) -> torch.Tensor:
    """[M, ps*8] int32 (0/1) -> [M, ps] uint8."""
    b = bits_i32.reshape(bits_i32.shape[0], -1, 8)
    weights = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=b.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def gf256_matmul(bitmat, data_u8: torch.Tensor) -> torch.Tensor:
    """GF(256) RS parity via one GF(2) product (reference ops/fec.py:122).

    bitmat: [(n-k)*8, k*8] expanded coefficient bit matrix (array or
    float32 tensor); data: [k, ss] uint8, each byte an independent GF(256)
    element -> parity [(n-k), ss] uint8.  Bit rows are per symbol, MSB
    first.  The float32 sums count at most ``8 k`` ones, so they are exact
    in any order; on the card TF32 is off (``device.py``).
    """
    k, ss = data_u8.shape
    bm = torch.as_tensor(bitmat, dtype=torch.float32, device=data_u8.device)
    # bit rows per symbol: [k, ss, 8] -> [k * 8, ss]
    bits = _unpack_bits(data_u8).reshape(k, ss, 8).permute(0, 2, 1).reshape(k * 8, ss)
    par_bits = torch.matmul(bm, bits).to(torch.int32) & 1  # [(n-k)*8, ss]
    m = par_bits.shape[0] // 8
    return _pack_bits(par_bits.reshape(m, 8, ss).permute(0, 2, 1).reshape(m, ss * 8))


# ---------------------------------------------------------------------------
# LDGM session
# ---------------------------------------------------------------------------

LDGM_HEADER_SIZE = 4  # ref: ldgm-session.h:124
DEFAULT_LDGM_SEED = 1  # ref: src/rtp/ldgm.hpp:48

# ref: suggested_configurations[], src/rtp/ldgm.cpp:116-139
# (mtu_class, frame_size, loss_pct) -> (k, m, c)
_LDGM_SUGGESTED = [
    ("STD1500", 144000, 2.0, 750, 120, 5),
    ("STD1500", 144000, 5.0, 1500, 450, 6),
    ("STD1500", 144000, 10.0, 1000, 500, 7),
    ("STD1500", 177000, 2.0, 1500, 240, 5),
    ("STD1500", 177000, 5.0, 1250, 375, 6),
    ("STD1500", 177000, 10.0, 1500, 750, 8),
    ("STD1500", 217000, 2.0, 1500, 240, 6),
    ("STD1500", 217000, 5.0, 1500, 450, 6),
    ("STD1500", 217000, 10.0, 1500, 750, 8),
    ("JUMBO9000", 4147200, 2.0, 1500, 180, 5),
    ("JUMBO9000", 4147200, 5.0, 1000, 300, 6),
    ("JUMBO9000", 4147200, 10.0, 1000, 500, 7),
    ("STD1500", 4147200, 2.0, 1500, 250, 5),
    ("STD1500", 4147200, 5.0, 1500, 650, 6),
    ("STD1500", 4147200, 10.0, 1500, 1500, 8),
]


def ldgm_suggest_params(frame_size: int, loss_pct: float, mtu: int = 1500) -> Tuple[int, int, int]:
    """Pick (k, m, c) like the reference percentage mode (ldgm.cpp:365-392)."""
    packet_type = "JUMBO9000" if mtu > 1500 else "STD1500"
    # snap loss to the nearest table class
    classes = [2.0, 5.0, 10.0]
    loss = min(classes, key=lambda x: abs(x - max(loss_pct, 0.01)))
    best = None
    for pt, fs, lo, k, m, c in _LDGM_SUGGESTED:
        if pt == packet_type and lo == loss:
            if best is None or abs(fs - frame_size) < abs(best[0] - frame_size):
                best = (fs, k, m, c)
    if best is None:
        return 512, 384, 5  # DEFAULT_K/M/C, ldgm.cpp:141-144
    return best[1], best[2], best[3]


@dataclasses.dataclass(frozen=True)
class FecDesc:
    """Wire FEC parameters (ref: struct fec_desc, src/types.h:210-215)."""

    type: str  # "ldgm" | "rs" | "none"
    k: int = 0
    m: int = 0
    c: int = 0
    seed: int = 0
    symbol_size: int = 0


class LdgmSession:
    """LDGM encode/decode with the reference's buffer layout (reference
    ``LdgmSession``, ops/fec.py:293).

    Output buffer = [uint32 frame_size][frame][zero pad so data part % (k*4)
    == 0][m parity symbols] (ref: LDGM_session::encode_frame,
    ldgm/src/ldgm-session.cpp:123-176).  ``matrix`` [m, k] optionally
    replaces the matrix built from the seed (the reference session's
    ``matrix``; see ``models.encode.state_from_reference``).
    """

    def __init__(self, k: int, m: int, c: int, seed: int = DEFAULT_LDGM_SEED,
                 matrix: Optional[np.ndarray] = None):
        self.k, self.m, self.c, self.seed = k, m, c, seed
        self.matrix = build_ldgm_matrix(k, m, c, seed) if matrix is None else np.array(matrix, np.uint8)
        if self.matrix.shape != (m, k):
            raise ValueError(f"LDGM matrix {self.matrix.shape} does not match ldgm:{k}:{m}:{c}")
        # compact row-index form for the C XOR encoder
        row_len = int(self.matrix.sum(axis=1).max())
        rows = np.full((m, row_len), -1, np.int32)
        for i in range(m):
            idx = np.nonzero(self.matrix[i])[0]
            rows[i, : idx.size] = idx
        self._rows = np.ascontiguousarray(rows)
        self._parity = Gf2Parity(self.matrix, 1)  # K2 over the mask, staircase on; any width by with_width
        self._peel = None  # K2 over the full check matrix, no staircase; any width by with_width
        self._checks = {}  # torch.device -> the full check matrix as bool there
        self.rounds = 0  # peel rounds of the last decode_device

    def encode_params(self, frame_size: int) -> Tuple[int, int]:
        """(packet/symbol size, total buffer size)."""
        align = self.k * 4
        data_size = frame_size + LDGM_HEADER_SIZE
        if data_size % align:
            data_size = (data_size // align + 1) * align
        ps = data_size // self.k
        return ps, data_size + self.m * ps

    def encode(self, frame: np.ndarray) -> Tuple[np.ndarray, FecDesc]:
        """frame: uint8 1-D -> (buffer uint8 1-D, FecDesc), on the host."""
        frame = np.asarray(frame, dtype=np.uint8).reshape(-1)
        ps, buf_size = self.encode_params(frame.size)
        data_size = buf_size - self.m * ps
        data = np.zeros(data_size, dtype=np.uint8)
        data[:4] = np.frombuffer(np.uint32(frame.size).tobytes(), np.uint8)
        data[4: 4 + frame.size] = frame
        parity = self._encode_host(data, ps)
        buf = np.concatenate([data, parity.reshape(-1)])
        return buf, FecDesc("ldgm", self.k, self.m, self.c, self.seed, ps)

    def encode_tensor(self, frame: torch.Tensor, hdr: bytes = b"") -> Tuple[torch.Tensor, FecDesc]:
        """The buffer of :meth:`encode` (``hdr`` ++ ``frame``) built on the
        frame's device: (uint8 [data part + m * ps] there, FecDesc),
        byte-equal to ``encode(hdr ++ frame)``.  One copy of the frame into
        the buffer on the device, the length word and ``hdr`` from the host,
        the pad zeroed, then the parity of the data part, with the
        staircase, written after it (on the card one K2 launch; on the CPU
        its plain version).  ``frame``: uint8, any shape (taken flat)."""
        flat = frame.reshape(-1)
        if flat.dtype != torch.uint8:
            raise ValueError(f"LDGM frame: expected uint8, got {flat.dtype}")
        size = len(hdr) + flat.numel()
        head = torch.frombuffer(bytearray(np.uint32(size).tobytes() + bytes(hdr)), dtype=torch.uint8)
        ps, buf_size = self.encode_params(size)
        data_size = buf_size - self.m * ps
        dev = flat.device
        buf = torch.empty(buf_size, dtype=torch.uint8, device=dev)
        buf[: head.numel()].copy_(head, non_blocking=True)  # staged at once: no wait for the stream
        buf[head.numel(): LDGM_HEADER_SIZE + size].copy_(flat)
        buf[LDGM_HEADER_SIZE + size: data_size].zero_()
        psw = ps // 4
        par = self._parity.with_width(psw)
        words = buf[:data_size].view(torch.int32)
        if dev.type == "cuda":
            par.launch(words, out=buf[data_size:].view(torch.int32).view(self.m, psw))
        else:
            buf[data_size:] = par.plain(words).reshape(-1).view(torch.uint8)
        return buf, FecDesc("ldgm", self.k, self.m, self.c, self.seed, ps)

    def _encode_host(self, data: np.ndarray, ps: int) -> np.ndarray:
        """The shared C XOR encoder (the reference's SSE CPU path analogue)."""
        parity = np.empty((self.m, ps), np.uint8)
        data = np.ascontiguousarray(data)
        native.ldgm_xor_lib().ldgm_encode_xor(
            data.ctypes.data, self.k, ps,
            self._rows.ctypes.data, self.m, self._rows.shape[1],
            parity.ctypes.data,
        )
        return parity

    def encode_device(self, data_symbols, device="cuda") -> torch.Tensor:
        """[k, ps] uint8 (header + frame + pad) -> [m, ps] uint8 parity, with
        the staircase.  A tensor is encoded on its own device (one K2 launch
        on the card); an array is copied to ``device`` first."""
        sym = _tensor(data_symbols, device)
        if sym.dim() != 2 or sym.shape[0] != self.k:
            raise ValueError(f"expected [{self.k}, ps] data symbols, got {tuple(sym.shape)}")
        ps = sym.shape[1]
        words = symbol_words(sym)
        return self._parity.with_width(words.shape[1])(words).view(torch.uint8)[:, :ps]

    def decode(self, symbols: np.ndarray, present: np.ndarray) -> Optional[np.ndarray]:
        """Erasure-recover the frame from received symbols, on the host.

        symbols: [k+m, ps] uint8 (missing rows arbitrary); present: [k+m]
        bool.  Returns the recovered frame bytes or None.  Peeling decoder
        over the staircase Tanner graph (ref: ldgm-session.cpp decoding).
        """
        k, m, ps = self.k, self.m, symbols.shape[1]
        sym = symbols.astype(np.uint8).copy()
        have = present.copy()
        # full parity-check rows: row i involves data cols (matrix) + parity
        # i and parity i-1 (staircase)
        rows: List[List[int]] = []
        for i in range(m):
            cols = [int(j) for j in np.nonzero(self.matrix[i])[0]]
            cols.append(k + i)
            if i > 0:
                cols.append(k + i - 1)
            rows.append(cols)
        changed = True
        while changed and not have[:k].all():
            changed = False
            for i in range(m):
                missing = [j for j in rows[i] if not have[j]]
                if len(missing) == 1:
                    j = missing[0]
                    acc = np.zeros(ps, np.uint8)
                    for col in rows[i]:
                        if col != j:
                            acc ^= sym[col]
                    sym[j] = acc
                    have[j] = True
                    changed = True
        if not have[:k].all():
            return None
        return self._frame(sym[:k].reshape(-1))

    @staticmethod
    def _frame(data: np.ndarray) -> Optional[np.ndarray]:
        """The frame inside the recovered data part, or None if its length
        word overruns it."""
        frame_size = int(np.frombuffer(data[:4].tobytes(), np.uint32)[0])
        if frame_size > data.size - 4:
            return None
        return data[4: 4 + frame_size]

    # -- device erasure decode -------------------------------------------

    def _full_check_matrix(self) -> np.ndarray:
        """[m, k+m] 0/1 parity-check rows over (data || parity) columns:
        row i = matrix row i + parity i + parity i-1 (LDPC staircase)."""
        k, m = self.k, self.m
        full = np.zeros((m, k + m), np.float32)
        full[:, :k] = self.matrix
        full[np.arange(m), k + np.arange(m)] = 1
        full[np.arange(1, m), k + np.arange(m - 1)] = 1
        return full

    def peel_parity(self, device: torch.device):
        """K2 over the full check matrix without the staircase, at a width
        of one word (``with_width`` gives any other), and the matrix as a
        bool tensor on ``device``: made once per session and device."""
        hb = self._checks.get(device)
        if hb is None:
            with profiler.zone("fec.peel.build"):
                full = self._full_check_matrix()
                if self._peel is None:
                    self._peel = Gf2Parity(full, 1, staircase=False)
                hb = self._checks[device] = torch.as_tensor(full != 0, device=device)
        return self._peel, hb

    def _decode_device_fn(self, ps: int, device: torch.device):
        """The peel for symbol size ``ps`` on ``device`` (reference
        ops/fec.py:413): ``run(sym, have)``, uint8 [k+m, ps] and bool
        [k+m] -> (sym, have, rounds).

        Each round, as the reference's ``while_loop``: every check row's
        XOR over the symbol block with the missing rows zeroed (K2 on the
        card: a row with one missing symbol XORs to its value), the rows
        with exactly one missing symbol, the first missing column of each
        (``argmax``), and a scatter of the values (duplicate targets write
        identical bytes; idle rows write a dummy row).  Rounds stop when one
        recovers nothing, after ``m + 2`` rounds, or when every data symbol
        is present; the host reads one flag per round.
        """
        k, m = self.k, self.m
        n = k + m
        psw = -(-ps // 4)
        peel, hb = self.peel_parity(device)
        peel = peel.with_width(psw)

        def run(sym, have):
            # row n is the dummy target of idle check rows
            words = torch.zeros(n + 1, psw, dtype=torch.int32, device=device)
            words[:n] = symbol_words(torch.where(have[:, None], sym, 0))
            have_p = torch.zeros(n + 1, dtype=torch.bool, device=device)
            have_p[:n] = have
            rounds = 0
            go = not bool(have[:k].all())
            while go and rounds < m + 2:
                with profiler.zone("fec.peel.round"):  # K2 through the host's read of the round's flag
                    old = have_p[:n].clone()
                    miss = hb & ~old  # [m, n]: the missing symbols of each check row
                    col = torch.argmax(miss.to(torch.uint8), dim=1)  # the first one
                    col = torch.where(miss.sum(dim=1) == 1, col, n)
                    vals = peel(words[:n])
                    words[col] = vals
                    have_p[col] = True
                    rounds += 1
                    go = bool(((have_p[:n] & ~old).any() & ~have_p[:k].all()).item())
            return words[:n].view(torch.uint8)[:, :ps], have_p[:n], rounds

        return run

    def decode_device(self, symbols, present, device="cuda") -> Optional[np.ndarray]:
        """Erasure recovery on tensors; same contract as :meth:`decode`
        (reference ``decode_device``, ops/fec.py:465).

        symbols: [k+m, ps] uint8, a tensor (decoded on its own device) or an
        array (copied to ``device``, the card unless the caller names
        another); present: [k+m] bool.  :attr:`rounds` holds the count of
        peel rounds.  Returns the frame bytes (numpy) or None.
        """
        n = self.k + self.m
        sym = _tensor(symbols, device)
        if sym.dim() != 2 or sym.shape[0] != n:
            raise ValueError(f"expected [{n}, ps] symbols, got {tuple(sym.shape)}")
        have = torch.as_tensor(np.asarray(present, bool).reshape(-1), device=sym.device)
        if have.numel() != n:
            raise ValueError(f"expected {n} presence flags, got {have.numel()}")
        run = self._decode_device_fn(sym.shape[1], sym.device)
        sym, have, self.rounds = run(sym.to(torch.uint8), have)
        if not bool(have[: self.k].all()):
            return None
        return self._frame(sym[: self.k].cpu().numpy().reshape(-1))


# ---------------------------------------------------------------------------
# Reed-Solomon GF(256) (zfec-compatible construction)
# ---------------------------------------------------------------------------

_GF_POLY = 0x11D  # 1 + x^2 + x^3 + x^4 + x^8 (zfec's primitive polynomial)


@lru_cache(maxsize=1)
def _gf_tables():
    exp = np.zeros(510, dtype=np.int32)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _GF_POLY
    exp[255:510] = exp[0:255]
    return exp, log


@lru_cache(maxsize=1)
def _gf_mul_table() -> np.ndarray:
    """[256, 256] uint8: a * b in GF(256)."""
    exp, log = _gf_tables()
    a = np.arange(256)
    t = exp[log[a][:, None] + log[a][None, :]].astype(np.uint8)
    t[0, :] = 0
    t[:, 0] = 0
    return t


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = _gf_tables()
    return int(exp[log[a] + log[b]])


def gf_inv(a: int) -> int:
    exp, log = _gf_tables()
    return int(exp[255 - log[a]])


def _gf_mat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b over GF(256) (the reference's triple loop, one row of products
    per inner index)."""
    mul = _gf_mul_table()
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for t in range(a.shape[1]):
        out ^= mul[a[:, t][:, None], b[t][None, :]]
    return out


def _gf_mat_inv(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(256), pivots chosen as the reference's."""
    mul = _gf_mul_table()
    n = mat.shape[0]
    a = np.asarray(mat, np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        nz = np.nonzero(a[col:, col])[0]
        if nz.size == 0:
            raise ValueError("singular GF matrix")
        pivot = col + int(nz[0])
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        pv = gf_inv(int(a[col, col]))
        a[col] = mul[a[col], pv]
        inv[col] = mul[inv[col], pv]
        f = a[:, col].copy()
        f[col] = 0
        a ^= mul[f[:, None], a[col][None, :]]
        inv ^= mul[f[:, None], inv[col][None, :]]
    return inv


@lru_cache(maxsize=8)
def rs_encode_matrix(k: int, n: int) -> np.ndarray:
    """Systematic encode matrix [n, k]: top k rows identity, bottom n-k
    parity coefficient rows (zfec fec_new construction)."""
    exp, _ = _gf_tables()
    i, j = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    # Vandermonde: vm[i][j] = alpha^(i*j)
    vm = exp[(i * j) % 255].astype(np.uint8)
    vm[0, 0] = 1
    enc = _gf_mat_mul(vm, _gf_mat_inv(vm[:k]))
    enc[:k] = np.eye(k, dtype=np.uint8)
    return enc


@lru_cache(maxsize=8)
def _gf2_companion_expand(k: int, n: int) -> np.ndarray:
    """Expand the parity part of the RS matrix into a GF(2) bit matrix
    [(n-k)*8, k*8]: each GF(256) coefficient a becomes the 8x8 matrix of
    x -> a*x over GF(2) bit vectors (MSB-first bit order)."""
    enc = rs_encode_matrix(k, n)[k:]
    m = enc.shape[0]
    # prod[i, j, bit] = enc[i, j] * 2^(7 - bit); its bit ob (MSB first)
    prod = _gf_mul_table()[enc[:, :, None], (1 << (7 - np.arange(8)))[None, None, :]]
    obits = (prod[..., None] >> (7 - np.arange(8))) & 1  # [m, k, bit, ob]
    return obits.transpose(0, 3, 1, 2).reshape(m * 8, k * 8).astype(np.float32)


class RsSession:
    """Reed-Solomon RS(k, n) over packets (reference ``RsSession``,
    ops/fec.py:600; ref: src/rtp/rs.cpp:155-220).

    Buffer layout = [uint32 len][payload][zero pad to k*ss]; n-k parity
    symbols appended.  Defaults k=200, n=240 for video (ref: rs.cpp:55-62).
    ``bitmat`` optionally replaces the expanded matrix (the reference
    session's ``_bitmat``; see ``models.encode.state_from_reference``).
    """

    MAX_K = 255

    def __init__(self, k: int = 200, n: int = 240, bitmat: Optional[np.ndarray] = None):
        if not 0 < k < n <= 255:
            raise ValueError(f"RS needs 0 < k < n <= 255, got k={k} n={n}")
        self.k, self.n = k, n
        self._bitmat = (_gf2_companion_expand(k, n) if bitmat is None
                        else np.array(bitmat, np.float32))
        if self._bitmat.shape != ((n - k) * 8, k * 8):
            raise ValueError(f"RS bit matrix {self._bitmat.shape} does not match rs:{k}:{n}")
        self._dev_bitmat = {}  # torch.device -> the bit matrix there

    def bitmat(self, device) -> torch.Tensor:
        """The expanded bit matrix as a float32 tensor on ``device``."""
        device = torch.device(device)
        t = self._dev_bitmat.get(device)
        if t is None:
            t = self._dev_bitmat[device] = torch.as_tensor(self._bitmat, device=device)
        return t

    def get_ss(self, hdr_len: int, payload_len: int) -> int:
        """Symbol size covering header+payload (ref: rs.cpp get_ss)."""
        total = 4 + hdr_len + payload_len
        return (total + self.k - 1) // self.k

    def encode(self, payload: np.ndarray, hdr: bytes = b"", device="cuda") -> Tuple[np.ndarray, FecDesc]:
        """Payload -> (buffer uint8 1-D, FecDesc); the parity product runs
        on ``device``, the card unless the caller names another."""
        payload = np.asarray(payload, dtype=np.uint8).reshape(-1)
        total = 4 + len(hdr) + payload.size
        ss = (total + self.k - 1) // self.k
        # reference aligns ss to 2 (word alignment, rs.cpp)
        ss = (ss + 1) & ~1
        data = np.zeros(self.k * ss, dtype=np.uint8)
        ln = np.uint32(len(hdr) + payload.size)
        data[:4] = np.frombuffer(ln.tobytes(), np.uint8)
        data[4: 4 + len(hdr)] = np.frombuffer(hdr, np.uint8)
        data[4 + len(hdr): 4 + len(hdr) + payload.size] = payload
        parity = self.encode_device(data.reshape(self.k, ss), device).cpu().numpy()
        buf = np.concatenate([data, parity.reshape(-1)])
        return buf, FecDesc("rs", self.k, self.n - self.k, 0, 0, ss)

    def encode_device(self, data_symbols, device="cuda") -> torch.Tensor:
        """[k, ss] uint8 -> [(n-k), ss] parity; a tensor on its own device,
        an array copied to ``device``."""
        sym = _tensor(data_symbols, device)
        return gf256_matmul(self.bitmat(sym.device), sym)

    def decode(self, symbols: np.ndarray, present: np.ndarray) -> Optional[np.ndarray]:
        """Recover data symbols from any k of n (host Gaussian elimination)."""
        k, n = self.k, self.n
        if present[:k].all():
            data = symbols[:k].reshape(-1)
        else:
            idx = [i for i in range(n) if present[i]][:k]
            if len(idx) < k:
                return None
            dec = _gf_mat_inv(rs_encode_matrix(k, n)[idx])
            data = _gf_mat_mul(dec, np.asarray(symbols, np.uint8)[idx]).reshape(-1)
        ln = int(np.frombuffer(data[:4].tobytes(), np.uint32)[0])
        if ln > data.size - 4:
            return None
        return data[4: 4 + ln]


# ---------------------------------------------------------------------------
# Module-level factory matching the reference's -f grammar
# ---------------------------------------------------------------------------


def fec_from_spec(spec: str, frame_size: int = 0, mtu: int = 1500):
    """Parse ``none | mult:N | ldgm:k:m:c | ldgm:P% | rs:k:n``
    (ref: -f grammar, src/main.cpp:254-256)."""
    if spec in ("", "none"):
        return None
    name, _, rest = spec.partition(":")
    if name == "ldgm":
        if rest.endswith("%"):
            k, m, c = ldgm_suggest_params(frame_size or 144000, float(rest[:-1]), mtu)
        elif rest:
            parts = rest.split(":")
            k, m, c = int(parts[0]), int(parts[1]), int(parts[2]) if len(parts) > 2 else 5
        else:
            k, m, c = 512, 384, 5
        return LdgmSession(k, m, c)
    if name == "rs":
        if rest:
            parts = rest.split(":")
            k = int(parts[0])
            n = int(parts[1]) if len(parts) > 1 else 240
        else:
            k, n = 200, 240
        return RsSession(k, n)
    if name == "mult":
        return ("mult", int(rest or 2))
    raise ValueError(f"unknown FEC {spec!r}")
