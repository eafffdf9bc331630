"""CineForm/VC-5-architecture intra wavelet codec on tensors (the ``UCF1``
container).

Port of ``ultragrid_tpu/ops/cineform.py`` (the reference's ``-c cineform``
role, src/video_compress/cineform.cpp over the CineForm SDK; the reference
package's codec is a from-scratch implementation of the same coding
architecture, SMPTE ST 2073 "VC-5" family core tools):

* **2/6 wavelet** -- unnormalised Haar low-pass plus the high-pass with the
  +-1/8 neighbour correction, as integer lifting (exactly invertible), a
  three-level 2-D Mallat pyramid; int32 tensor ops on the codec's device,
  the reference's values exactly.
* **Per-subband dead-zone quantisation** and the **zero-run / magnitude
  Exp-Golomb entropy layer**: host numpy, copied as is.

``UCF1`` is the lossless mode of ``-c cineform`` and its container for
geometry that real CFHD cannot carry; the real CineForm HD sample
bitstream is :mod:`ultragrid_tpu_torch.ops.cfhd_bitstream` (host numpy, as
in the reference).  The device/host split is the one of
:mod:`ultragrid_tpu_torch.ops.jpegxs`: one upload of a plane, one copy of
its bands down; on decode one upload of its bands, the inverse on the
device.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, on_device
from ultragrid_tpu_torch.ops.jpegxs import (_BitWriter, bands_to_device, bands_to_host, component_headers,
                                            pad_edge, parse_header)

MAGIC = b"UCF1"

# ---------------------------------------------------------------------------
# 2/6 wavelet (integer lifting, exactly invertible)
# ---------------------------------------------------------------------------


def _dwt26_1d(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One 2/6 level along ``axis`` (even length required).

    s[n] = x[2n] + x[2n+1]                       (unnormalized Haar low)
    d[n] = (x[2n] - x[2n+1]) + ((s[n-1] - s[n+1] + 4) >> 3)

    with edge clamping of the s neighbourhood.  Inverse recovers
    x exactly: t = d - corr(s); x[2n] = (s+t)>>1 (s+t = 2*x[2n] is even).
    """
    x = x.movedim(axis, -1)
    even = x[..., 0::2]
    odd = x[..., 1::2]
    s = even + odd
    t = even - odd
    sm = torch.cat([s[..., :1], s[..., :-1]], dim=-1)  # s[n-1]
    sp = torch.cat([s[..., 1:], s[..., -1:]], dim=-1)  # s[n+1]
    d = t + ((sm - sp + 4) >> 3)
    return s.movedim(-1, axis), d.movedim(-1, axis)


def _idwt26_1d(s: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    s = s.movedim(axis, -1)
    d = d.movedim(axis, -1)
    sm = torch.cat([s[..., :1], s[..., :-1]], dim=-1)
    sp = torch.cat([s[..., 1:], s[..., -1:]], dim=-1)
    t = d - ((sm - sp + 4) >> 3)
    even = (s + t) >> 1
    odd = s - even
    out = torch.stack([even, odd], dim=-1).reshape(*even.shape[:-1], -1)
    return out.movedim(-1, axis)


def dwt26_forward(plane: torch.Tensor, levels: int) -> List[Tuple[str, torch.Tensor]]:
    """3-level (default) 2D pyramid -> [(name, band)] with the final LL
    first.  Band names: L<k>{LH,HL,HH} for level k (1 = finest)."""
    bands: List[Tuple[str, torch.Tensor]] = []
    ll = plane
    for lvl in range(1, levels + 1):
        lo, hi = _dwt26_1d(ll, axis=1)
        ll_, lh = _dwt26_1d(lo, axis=0)
        hl, hh = _dwt26_1d(hi, axis=0)
        bands.insert(0, (f"L{lvl}HH", hh))
        bands.insert(0, (f"L{lvl}HL", hl))
        bands.insert(0, (f"L{lvl}LH", lh))
        ll = ll_
    bands.insert(0, ("LL", ll))
    return bands


def dwt26_inverse(bands: List[Tuple[str, torch.Tensor]], levels: int) -> torch.Tensor:
    named = dict(bands)
    ll = named["LL"]
    for lvl in range(levels, 0, -1):
        lo = _idwt26_1d(ll, named[f"L{lvl}LH"], axis=0)
        hi = _idwt26_1d(named[f"L{lvl}HL"], named[f"L{lvl}HH"], axis=0)
        ll = _idwt26_1d(lo, hi, axis=1)
    return ll


# ---------------------------------------------------------------------------
# Entropy layer: zero-run / magnitude Exp-Golomb tokens (host; a copy of
# the reference's)
# ---------------------------------------------------------------------------

_RUN_CAP = 16383  # chunk long runs; EG(16383) = 27 bits


def _eg_len(u: np.ndarray) -> np.ndarray:
    """Exp-Golomb code length of u >= 0: 2*floor(log2(u+1))+1."""
    k = np.int32(np.log2(u.astype(np.int64) + 1))
    # guard fp edge at exact powers of two
    k = np.where((np.int64(1) << (k + 1)) <= u.astype(np.int64) + 1, k + 1, k)
    k = np.where((np.int64(1) << k) > u.astype(np.int64) + 1, k - 1, k)
    return 2 * k + 1


def _encode_band_rle(band: np.ndarray, q: int, bw: _BitWriter) -> None:
    """Quantize + RLE/EG encode one band into the bit writer.

    Token stream: (EG(run) EG(mag) [sign])* where mag = 0 means "run
    continuation, no coefficient" (used to chunk runs > _RUN_CAP and to
    flush trailing zeros); decoding stops when run totals + coefficient
    count cover the band.
    """
    flat = band.reshape(-1)
    if q > 1:
        flat = np.sign(flat) * (np.abs(flat) // q)
    nz_idx = np.flatnonzero(flat)
    mags = np.abs(flat[nz_idx]).astype(np.int64)
    signs = (flat[nz_idx] < 0).astype(np.uint32)
    # zero runs before each nonzero + the trailing run
    prev = np.concatenate([[-1], nz_idx])
    runs = (np.diff(prev) - 1).astype(np.int64)
    trailing = flat.size - 1 - (nz_idx[-1] if nz_idx.size else -1)

    # Per-coefficient token triples (run, mag, sign), vectorized; runs
    # beyond the cap spill into escape tokens (run=_RUN_CAP, mag=0), each
    # of which covers _RUN_CAP+1 zero positions at the decoder.
    n = nz_idx.size
    if n:
        nesc = (runs // (_RUN_CAP + 1)).astype(np.int64)  # escapes per coeff
        total_tokens = int(n + nesc.sum())
        run_vals = np.full(total_tokens, _RUN_CAP, np.int64)
        mag_vals = np.zeros(total_tokens, np.int64)
        sign_vals = np.zeros(total_tokens, np.uint32)
        is_coef = np.zeros(total_tokens, bool)
        pos = np.cumsum(nesc + 1) - 1  # index of each real-coefficient token
        run_vals[pos] = runs % (_RUN_CAP + 1)
        mag_vals[pos] = mags
        sign_vals[pos] = signs
        is_coef[pos] = True
        vals = np.stack(
            [(run_vals + 1).astype(np.uint32), (mag_vals + 1).astype(np.uint32), sign_vals],
            axis=1,
        ).reshape(-1)
        lens = np.stack(
            [_eg_len(run_vals), _eg_len(mag_vals), np.where(is_coef, 1, 0)], axis=1
        ).reshape(-1).astype(np.int32)
    else:
        vals = np.empty(0, np.uint32)
        lens = np.empty(0, np.int32)
    # trailing zeros: mag=0 tokens, each covering run+1 positions, summing
    # to EXACTLY `trailing` (any mismatch would desync the next band in the
    # shared bit stream)
    t_runs = []
    rem = int(trailing)
    while rem > 0:
        chunk = min(rem - 1, _RUN_CAP)
        t_runs.append(chunk)
        rem -= chunk + 1
    if t_runs:
        tr = np.asarray(t_runs, np.int64)
        vals2 = np.stack(
            [(tr + 1).astype(np.uint32), np.ones_like(tr, np.uint32)], axis=1
        ).reshape(-1)
        lens2 = np.stack([_eg_len(tr), np.ones_like(tr)], axis=1).reshape(-1).astype(np.int32)
        vals = np.concatenate([vals, vals2])
        lens = np.concatenate([lens, lens2])
    bw.put_bits_vec(vals.astype(np.uint32), lens.astype(np.int32))


class _Bits:
    """Sequential EG-token reader over a byte string (decode side)."""

    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.ones = np.flatnonzero(self.bits)
        self.pos = 0

    def read_eg(self) -> int:
        i = np.searchsorted(self.ones, self.pos)
        one_at = int(self.ones[i])
        k = one_at - self.pos
        val = 1
        for b in self.bits[one_at + 1 : one_at + 1 + k]:
            val = (val << 1) | int(b)
        self.pos = one_at + 1 + k
        return val - 1

    def read_bit(self) -> int:
        b = int(self.bits[self.pos])
        self.pos += 1
        return b


def _decode_band_rle(h: int, w: int, q: int, br: _Bits) -> np.ndarray:
    out = np.zeros(h * w, np.int64)
    pos = 0
    size = h * w
    while pos < size:
        run = br.read_eg()
        mag = br.read_eg()
        if mag == 0:  # escape / trailing: run zeros + one implicit zero
            pos += run + 1
            continue
        pos += run
        sign = br.read_bit()
        out[pos] = -mag if sign else mag
        pos += 1
    if q > 1:
        nz = out != 0
        out[nz] = np.sign(out[nz]) * (np.abs(out[nz]) * q + q // 2)
    return out.reshape(h, w)


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

# band quantizer gains, finest level penalized most (VC-5 band gain role)
_BAND_QSHIFT = {"LL": 0, "L3LH": 0, "L3HL": 0, "L3HH": 1,
                "L2LH": 1, "L2HL": 1, "L2HH": 2,
                "L1LH": 2, "L1HL": 2, "L1HH": 3}


class CineformCodec:
    """Encoder/decoder over planar components (any int content <= 12 bit),
    the wavelet on ``device`` (the card unless the caller names another).

    quality: 100 = lossless (q=1 everywhere); lower quality scales the
    per-band quantizers up (error bound per coefficient <= q of its band).
    """

    def __init__(self, levels: int = 3, quality: int = 100, device="cuda"):
        self.levels = levels
        self.quality = quality
        self.base_q = max(1, (100 - quality) // 8 + 1) if quality < 100 else 1
        self.device = get_device(device)

    def _q_for(self, name: str) -> int:
        if self.base_q == 1:
            return 1
        return self.base_q << _BAND_QSHIFT.get(name, 0)

    def analyse(self, plane: torch.Tensor) -> List[Tuple[str, np.ndarray]]:
        """The device stage of the encoder: one plane on the codec's device,
        padded to whole levels, through the wavelet, its bands on the host in
        one copy."""
        h, w = plane.shape
        align = 1 << self.levels
        padded = pad_edge(plane, h + (-h % align), w + (-w % align)).to(torch.int32)
        return bands_to_host(dwt26_forward(padded, self.levels))

    def synthesise(self, bands: List[Tuple[str, np.ndarray]]) -> torch.Tensor:
        """The device stage of the decoder: a plane's host bands uploaded in
        one copy and through the inverse wavelet on the codec's device."""
        return dwt26_inverse(bands_to_device(bands, self.device), self.levels)

    def encode_planes(self, planes) -> bytes:
        """planes: integer arrays or tensors; an array is copied to the
        codec's device, a tensor must be there.  Returns the UCF1 stream."""
        bw = _BitWriter()
        headers = []
        for plane in planes:
            plane = on_device(plane, self.device)
            bandinfo = []
            for name, band_np in self.analyse(plane):
                _encode_band_rle(band_np, self._q_for(name), bw)
                bandinfo.append((name, band_np.shape[0], band_np.shape[1]))
            headers.append((*plane.shape, bandinfo))
        payload = bw.tobytes()
        return (MAGIC + struct.pack("<BBB", len(planes), self.levels, self.base_q)
                + component_headers(headers) + struct.pack("<I", len(payload)) + payload)

    def decode_planes(self, data: bytes) -> List[torch.Tensor]:
        """A UCF1 stream -> its int32 planes on the codec's device."""
        assert data[:4] == MAGIC, "not a UCF1 stream"
        ncomp, levels, base_q = struct.unpack_from("<BBB", data, 4)
        self.levels, self.base_q = levels, base_q
        comps, off, paylen = parse_header(data, 7, ncomp)
        br = _Bits(data[off : off + paylen])
        out = []
        for w, h, bands in comps:
            decoded = [(name, _decode_band_rle(bh, bw_, self._q_for(name), br).astype(np.int32))
                       for name, bh, bw_ in bands]
            out.append(self.synthesise(decoded)[:h, :w])
        return out
