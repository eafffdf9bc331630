"""JPEG XS-architecture low-latency wavelet codec on tensors.

Port of ``ultragrid_tpu/ops/jpegxs.py`` (the reference's ``-c jpegxs``
role, src/video_compress/jpegxs.cpp over the SVT-JPEG-XS SDK; the
reference package's codec is a from-scratch implementation of the same
coding architecture, ISO/IEC 21122-1 core tools, in its own container
``UXS1``; no field-level conformance with ISO/IEC 21122 codestreams is
claimed there or here):

* **5/3 reversible LeGall DWT** -- NLx horizontal levels and NLy in {0, 1}
  vertical levels, whole-plane lifting steps as int32 tensor ops on the
  codec's device.  ``>>`` on int32 is an arithmetic shift in torch as in
  ``jnp``, so the bands are the reference's exactly.
* **Group significance coding** -- the host entropy layer, copied as is
  (numpy): groups of 4, MSB positions with vertical prediction, raw
  magnitude bitplanes and signs.
* **Per-band truncation** of LSB planes for lossy operation.

The split between device and host: a plane goes to the device once, its
padding (the reference's edge padding) and DWT run there, and all its bands
come back to the host in one copy (one flat tensor, split on the host).
The decoder decodes a plane's bands on the host, uploads them in one copy
and runs the inverse DWT on the device; its planes stay there.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, on_device

MAGIC = b"UXS1"

# ---------------------------------------------------------------------------
# 5/3 reversible DWT (LeGall lifting, the JPEG XS transform)
# ---------------------------------------------------------------------------


def _dwt53_1d(x: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One 5/3 lifting level along ``axis`` (even length required).

    d[n] = x[2n+1] - floor((x[2n] + x[2n+2]) / 2)        (predict)
    s[n] = x[2n]   + floor((d[n-1] + d[n] + 2) / 4)      (update)
    with symmetric edge extension; integer, exactly invertible.
    """
    x = x.movedim(axis, -1)
    even = x[..., 0::2]
    odd = x[..., 1::2]
    even_r = torch.cat([even[..., 1:], even[..., -1:]], dim=-1)
    d = odd - ((even + even_r) >> 1)
    d_l = torch.cat([d[..., :1], d[..., :-1]], dim=-1)
    s = even + ((d_l + d + 2) >> 2)
    return s.movedim(-1, axis), d.movedim(-1, axis)


def _idwt53_1d(s: torch.Tensor, d: torch.Tensor, axis: int) -> torch.Tensor:
    """Inverse of :func:`_dwt53_1d`."""
    s = s.movedim(axis, -1)
    d = d.movedim(axis, -1)
    d_l = torch.cat([d[..., :1], d[..., :-1]], dim=-1)
    even = s - ((d_l + d + 2) >> 2)
    even_r = torch.cat([even[..., 1:], even[..., -1:]], dim=-1)
    odd = d + ((even + even_r) >> 1)
    out = torch.stack([even, odd], dim=-1).reshape(*even.shape[:-1], -1)
    return out.movedim(-1, axis)


def dwt53_forward(plane: torch.Tensor, nlx: int, nly: int) -> List[Tuple[str, torch.Tensor]]:
    """Multi-level 2-D DWT; returns [(band_name, band)] in decode order.

    ``nly`` vertical levels (0 or 1) first, then ``nlx`` horizontal levels on
    the low band (the XS low-latency layout).
    """
    bands: List[Tuple[str, torch.Tensor]] = []
    lo = plane.to(torch.int32)
    if nly:
        lo, hi = _dwt53_1d(lo, 0)
        # the vertical high band still gets one horizontal split (XS: HH/HL)
        hlo, hhi = _dwt53_1d(hi, 1)
        bands.append(("HL1v", hhi))
        bands.append(("LH1v", hlo))
    for lev in range(1, nlx + 1):
        lo, hi = _dwt53_1d(lo, 1)
        bands.append((f"H{lev}", hi))
    bands.append(("LL", lo))
    return bands


def dwt53_inverse(bands: List[Tuple[str, torch.Tensor]], nlx: int, nly: int) -> torch.Tensor:
    named = dict(bands)
    lo = named["LL"]
    for lev in range(nlx, 0, -1):
        lo = _idwt53_1d(lo, named[f"H{lev}"], 1)
    if nly:
        hi = _idwt53_1d(named["LH1v"], named["HL1v"], 1)
        lo = _idwt53_1d(lo, hi, 0)
    return lo


def pad_edge(plane: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``plane`` grown to [ph, pw] by repeating its last row and column
    (``np.pad(..., mode="edge")``), on its device."""
    h, w = plane.shape
    if (ph, pw) == (h, w):
        return plane
    rows = torch.arange(ph, device=plane.device).clamp_(max=h - 1)
    cols = torch.arange(pw, device=plane.device).clamp_(max=w - 1)
    return plane[rows][:, cols]


def bands_to_host(bands: List[Tuple[str, torch.Tensor]]) -> List[Tuple[str, np.ndarray]]:
    """The bands of one plane on the host, in one copy: one flat tensor
    comes down and is split there."""
    flat = torch.cat([b.reshape(-1) for _, b in bands]).cpu().numpy()
    out, off = [], 0
    for name, b in bands:
        n = b.numel()
        out.append((name, flat[off:off + n].reshape(tuple(b.shape))))
        off += n
    return out


def bands_to_device(bands: List[Tuple[str, np.ndarray]], device) -> List[Tuple[str, torch.Tensor]]:
    """Host int32 bands of one plane on ``device``, in one upload."""
    flat = torch.from_numpy(np.concatenate([b.reshape(-1) for _, b in bands])).to(device)
    out, off = [], 0
    for name, b in bands:
        out.append((name, flat[off:off + b.size].view(b.shape)))
        off += b.size
    return out


# ---------------------------------------------------------------------------
# Entropy layer: groups of 4, MSB-position coding, raw bitplanes (host; a
# copy of the reference's)
# ---------------------------------------------------------------------------

NG = 4  # coefficients per group (XS Ng)


def _group_msb(mag: np.ndarray) -> np.ndarray:
    """[n, NG] magnitudes -> [n] bitplane count per group (0 = all zero)."""
    gmax = mag.max(axis=1)
    return np.where(gmax == 0, 0, np.floor(np.log2(np.maximum(gmax, 1))).astype(np.int64) + 1)


class _BitWriter:
    def __init__(self):
        self._chunks: List[np.ndarray] = []
        self._nbits = 0

    def put_bits_vec(self, vals: np.ndarray, lens: np.ndarray) -> None:
        """Append per-element ``lens[i]`` MSB-first bits of ``vals[i]``."""
        vals = np.asarray(vals, np.uint64)
        lens = np.asarray(lens, np.int64)
        total = int(lens.sum())
        if total == 0:
            return
        ends = np.cumsum(lens)
        starts = ends - lens
        idx = np.arange(total)
        gi = np.searchsorted(ends, idx, side="right")
        within = idx - starts[gi]
        shift = (lens[gi] - 1 - within).astype(np.uint64)
        bits = ((vals[gi] >> shift) & 1).astype(np.uint8)
        self._chunks.append(bits)
        self._nbits += total

    def tobytes(self) -> bytes:
        if not self._chunks:
            return b""
        bits = np.concatenate(self._chunks)
        pad = (-bits.size) % 8
        if pad:
            bits = np.pad(bits, (0, pad))
        return np.packbits(bits).tobytes()


class _BitReader:
    def __init__(self, data: bytes):
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = 0
        self._ones = np.flatnonzero(self.bits)  # for O(1) unary scans

    def take_unary(self, count: int) -> np.ndarray:
        """Read ``count`` unary codes (q zeros then a '1'); returns q[]."""
        if count == 0:
            return np.zeros(0, np.int64)
        start = np.searchsorted(self._ones, self.pos)
        ones_pos = self._ones[start : start + count]
        prev = np.concatenate([[self.pos - 1], ones_pos[:-1]])
        q = ones_pos - prev - 1
        self.pos = int(ones_pos[-1]) + 1
        return q.astype(np.int64)

    def take(self, lens: np.ndarray) -> np.ndarray:
        """Read len[i] MSB-first bits per element; returns values."""
        lens = np.asarray(lens, np.int64)
        total = int(lens.sum())
        chunk = self.bits[self.pos : self.pos + total].astype(np.uint64)
        self.pos += total
        ends = np.cumsum(lens)
        starts = ends - lens
        out = np.zeros(lens.size, np.uint64)
        idx = np.arange(total)
        gi = np.searchsorted(ends, idx, side="right")
        within = idx - starts[gi]
        shift = (lens[gi] - 1 - within).astype(np.uint64)
        np.add.at(out, gi, chunk << shift)
        return out


def _encode_band(band: np.ndarray, trunc: int, bw: "_BitWriter") -> None:
    """XS-style band packet: per-group MSB counts (vertically predicted
    unary deltas), then magnitude bitplanes above the truncation point,
    then sign bits of significant coefficients."""
    h, w = band.shape
    padw = (-w) % NG
    if padw:
        band = np.pad(band, ((0, 0), (0, padw)))
    g = band.reshape(h, -1, NG)
    mag = np.abs(g)
    msb = _group_msb(mag.reshape(-1, NG)).reshape(h, -1)
    msb = np.maximum(msb - trunc, 0)  # truncated planes need no coding
    # vertical prediction: first row predicts 0, others the row above
    pred = np.vstack([np.zeros((1, msb.shape[1]), np.int64), msb[:-1]])
    delta = msb - pred
    # signed unary: q = 2|d| - [d>0] zeros then a 1 terminator
    q = np.where(delta > 0, 2 * delta - 1, -2 * delta)
    flat_q = q.reshape(-1)
    bw.put_bits_vec(np.ones_like(flat_q), flat_q + 1)  # 0^q '1'
    # data: for each group, (msb - trunc... already subtracted) planes of
    # each of the NG magnitudes (MSB-first), then signs of nonzero coeffs
    counts = msb.reshape(-1)
    mags = (mag.reshape(-1, NG) >> trunc).astype(np.uint64)
    lens = np.repeat(counts, NG)
    bw.put_bits_vec(mags.reshape(-1), lens)
    nz = mags.reshape(-1) != 0
    sgn = (g.reshape(-1)[nz] < 0).astype(np.uint64)
    bw.put_bits_vec(sgn, np.ones(sgn.size, np.int64))


def _decode_band(h: int, w: int, trunc: int, br: "_BitReader") -> np.ndarray:
    padw = (-w) % NG
    gw = (w + padw) // NG
    # unary MSB deltas, row by row (vertical prediction dependency)
    msb = np.zeros((h, gw), np.int64)
    pred = np.zeros(gw, np.int64)
    for r in range(h):
        q = br.take_unary(gw)
        delta = np.where(q % 2 == 1, (q + 1) // 2, -(q // 2))
        msb[r] = pred + delta
        pred = msb[r]
    counts = msb.reshape(-1)
    lens = np.repeat(counts, NG)
    mags = br.take(lens).reshape(-1, NG).astype(np.int64) << trunc
    nz = mags.reshape(-1) != 0
    sgn = br.take(np.ones(int(nz.sum()), np.int64))
    coeffs = mags.reshape(-1)
    signs = np.ones(coeffs.size, np.int64)
    signs[nz] = np.where(sgn == 1, -1, 1)
    out = (coeffs * signs).reshape(h, gw * NG)[:, :w]
    return out


# ---------------------------------------------------------------------------
# Codec
# ---------------------------------------------------------------------------

# per-band truncation offsets relative to the quality-derived base: high
# frequency bands tolerate more truncation (the XS gain-table role)
_BAND_PRIO = {"LL": 2, "H5": 1, "H4": 1, "H3": 0, "H2": 0, "H1": 0,
              "LH1v": 0, "HL1v": 0}


def parse_header(data: bytes, off: int, ncomp: int):
    """The per-component headers of a UXS1 or UCF1 stream from ``off``:
    ([(w, h, [(name, bh, bw)])], the payload's offset and length)."""
    comps = []
    for _ in range(ncomp):
        w, h, nbands = struct.unpack_from("<HHB", data, off)
        off += 5
        bands = []
        for _ in range(nbands):
            (ln,) = struct.unpack_from("<B", data, off)
            off += 1
            name = data[off : off + ln].decode()
            off += ln
            bw_, bh = struct.unpack_from("<HH", data, off)
            off += 4
            bands.append((name, bh, bw_))
        comps.append((w, h, bands))
    (paylen,) = struct.unpack_from("<I", data, off)
    return comps, off + 4, paylen


def component_headers(headers) -> bytes:
    """The per-component headers and nothing else of a UXS1 or UCF1 stream:
    [(h, w, [(name, bh, bw)])] -> bytes."""
    hdr = bytearray()
    for h, w, bandinfo in headers:
        hdr += struct.pack("<HHB", w, h, len(bandinfo))
        for name, bh, bw_ in bandinfo:
            nb = name.encode()
            hdr += struct.pack("<B", len(nb)) + nb + struct.pack("<HH", bw_, bh)
    return bytes(hdr)


class JpegXsCodec:
    """Encoder/decoder pair over planar components, the DWT on ``device``
    (the card unless the caller names another).

    quality: 100 = lossless (T=0 everywhere); lower values truncate more
    LSB planes (roughly 2 quality steps per extra plane).
    """

    def __init__(self, nlx: int = 3, nly: int = 1, quality: int = 100, device="cuda"):
        self.nlx = nlx
        self.nly = nly
        self.quality = quality
        self.base_trunc = max(0, (100 - quality) // 10)
        self.device = get_device(device)

    def _trunc_for(self, name: str) -> int:
        if self.base_trunc == 0:
            return 0
        return max(0, self.base_trunc - _BAND_PRIO.get(name, 0))

    def analyse(self, plane: torch.Tensor) -> List[Tuple[str, np.ndarray]]:
        """The device stage of the encoder: one plane on the codec's device,
        padded to whole lifting steps, through the DWT, its bands on the host
        in one copy."""
        h, w = plane.shape
        # pad to even dims for the lifting steps
        ph, pw = h + (h % 2 if self.nly else 0), w + (w % (1 << self.nlx) and ((1 << self.nlx) - w % (1 << self.nlx)))
        return bands_to_host(dwt53_forward(pad_edge(plane, ph, pw).to(torch.int32), self.nlx, self.nly))

    def synthesise(self, bands: List[Tuple[str, np.ndarray]]) -> torch.Tensor:
        """The device stage of the decoder: a plane's host bands uploaded in
        one copy and through the inverse DWT on the codec's device."""
        return dwt53_inverse(bands_to_device(bands, self.device), self.nlx, self.nly)

    def encode_planes(self, planes) -> bytes:
        """planes: integer arrays or tensors (any bit depth <= 16); an array
        is copied to the codec's device, a tensor must be there.  Returns
        the UXS1 stream."""
        bw = _BitWriter()
        headers = []
        for plane in planes:
            plane = on_device(plane, self.device)
            bandinfo = []
            for name, band_np in self.analyse(plane):
                _encode_band(band_np, self._trunc_for(name), bw)
                bandinfo.append((name, band_np.shape[0], band_np.shape[1]))
            headers.append((*plane.shape, bandinfo))
        payload = bw.tobytes()
        return (MAGIC + struct.pack("<BBBB", len(planes), self.nlx, self.nly, self.base_trunc)
                + component_headers(headers) + struct.pack("<I", len(payload)) + payload)

    def decode_planes(self, data: bytes) -> List[torch.Tensor]:
        """A UXS1 stream -> its int32 planes on the codec's device."""
        assert data[:4] == MAGIC, "not a UXS1 stream"
        ncomp, nlx, nly, base_trunc = struct.unpack_from("<BBBB", data, 4)
        self.nlx, self.nly, self.base_trunc = nlx, nly, base_trunc
        comps, off, paylen = parse_header(data, 8, ncomp)
        br = _BitReader(data[off : off + paylen])
        out = []
        for w, h, bands in comps:
            decoded = [(name, _decode_band(bh, bw_, self._trunc_for(name), br).astype(np.int32))
                       for name, bh, bw_ in bands]
            out.append(self.synthesise(decoded)[:h, :w])
        return out
