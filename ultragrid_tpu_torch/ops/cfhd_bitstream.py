"""CineForm HD (CFHD) sample-stream codec — the wire format lavc's `cfhd`
decoder parses (round-4 verdict ask #3).

The reference reaches CFHD through the proprietary Cineform SDK
(src/video_compress/cineform.cpp); this is a from-scratch
implementation of the bitstream itself, built against the system
libavcodec decoder as conformance oracle (the same technique as the J2K
module's OpenJPEG gate):

* container: big-endian 16-bit tag/value pairs (SampleIndexTable with
  per-channel byte sizes, transform/channel/subband headers, bitstream
  markers 0x1a4a/0x0f0f/0x0d0d/0x0e0e, BandTrailer),
* transform: 3-level 2D 2/6 wavelet, horizontal then vertical per level,
  integer lifting constructed as the EXACT inverse of the decoder's
  reconstruction filters (interior: out_even = ((L[i-1]-L[i+1]+4)>>3
  + L[i] + H[i]) >> 1; 11/-4/1 and 5/4/-1 border taps), per-level
  prescale shifts,
* entropy: the "table 18" run/level prefix code (ops/cfhd_tables.py,
  recovered from the system codec's static data), sign bit per nonzero
  level, (run 2, level 255) end-of-band escape, band data padded to
  32-bit alignment before the BandTrailer tag.

The port's copy of ``ultragrid_tpu/ops/cfhd_bitstream.py`` (numpy, on the
host, as in the reference; only the import of the tables is renamed).

Both directions live here: `CfhdEncoder.encode` emits streams libavcodec
decodes (PSNR-gated in tests), `cfhd_decode` parses both our own and
libavcodec-encoder streams.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.ops.cfhd_tables import BITS, LENS, LEVELS, RUNS

# ---------------------------------------------------------------------------
# entropy layer
# ---------------------------------------------------------------------------


def _encode_tables():
    """(code, len) for level v in 1..255 (sign appended by caller), the
    zero-run codes sorted desc, and the single-zero + band-end codes."""
    lvl_code = {}
    run_code = {}
    end_code = None
    for b, l, r, v in zip(BITS.tolist(), LENS.tolist(), RUNS.tolist(),
                          LEVELS.tolist()):
        if r == 2 and v == 255:
            end_code = (b, l)
        elif v:
            lvl_code.setdefault(v, (b, l))
        else:
            run_code.setdefault(r, (b, l))
    runs_desc = sorted(run_code, reverse=True)
    return lvl_code, run_code, runs_desc, end_code


_LVL_CODE, _RUN_CODE, _RUNS_DESC, _END_CODE = _encode_tables()


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, code: int, length: int) -> None:
        self.bits.extend((code >> (length - 1 - k)) & 1 for k in range(length))

    def tobytes_padded(self, align_bytes: int = 4) -> bytes:
        bits = self.bits
        pad = (-len(bits)) % (8 * align_bytes)
        arr = np.array(bits + [0] * pad, np.uint8)
        return np.packbits(arr).tobytes()


def encode_band(coeffs: np.ndarray) -> bytes:
    """Run/level-encode one band (row-major int array) -> padded bytes.

    Every coefficient position is coded explicitly (the decoder consumes
    exactly width*height coefficients — trailing zeros may NOT be left
    implicit), then the end-of-band escape."""
    flat = np.asarray(coeffs, np.int64).reshape(-1)
    flat = np.clip(flat, -255, 255)
    bw = _BitWriter()
    nz = np.flatnonzero(flat)
    pos = 0

    def put_zeros(zeros):
        while zeros > 0:
            for r in _RUNS_DESC:
                if r <= zeros:
                    c, l = _RUN_CODE[r]
                    bw.put(c, l)
                    zeros -= r
                    break

    for idx in nz.tolist():
        put_zeros(idx - pos)
        v = int(flat[idx])
        c, l = _LVL_CODE[abs(v)]
        bw.put((c << 1) | (1 if v < 0 else 0), l + 1)
        pos = idx + 1
    put_zeros(flat.size - pos)
    c, l = _END_CODE
    bw.put(c, l)
    return bw.tobytes_padded(4)


def _decode_map():
    m = {}
    for b, l, r, v in zip(BITS.tolist(), LENS.tolist(), RUNS.tolist(),
                          LEVELS.tolist()):
        if r == 2 and v == 255:
            m[(b, l)] = ("end", 0)
        elif v:
            m[(b << 1, l + 1)] = (r, v)
            m[((b << 1) | 1, l + 1)] = (r, -v)
        else:
            m[(b, l)] = (r, 0)
    return m


_DEC_MAP = _decode_map()


def decode_band(data: bytes, start_bit: int, n: int) -> Tuple[np.ndarray, int]:
    """Decode ``n`` coefficients; returns (coeffs, bits consumed)."""
    out = np.zeros(n, np.int64)
    acc = alen = 0
    i = start_bit
    pos = 0
    nbits = 8 * len(data)
    while i < nbits:
        acc = (acc << 1) | ((data[i >> 3] >> (7 - (i & 7))) & 1)
        alen += 1
        i += 1
        hit = _DEC_MAP.get((acc, alen))
        if hit is None:
            if alen > 27:
                raise ValueError("CFHD band code desync")
            continue
        r, v = hit
        if r == "end":
            break
        if v == 0:
            pos += r
        else:
            pos += r - 1
            if pos < n:
                out[pos] = v
            pos += 1
        acc = alen = 0
        if pos > n + 320:
            raise ValueError("CFHD band overrun")
    return out, i - start_bit


# ---------------------------------------------------------------------------
# 2/6 wavelet (integer lifting; exact inverse pair)
# ---------------------------------------------------------------------------


def _fwd26_1d(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Along the last axis (even length >= 6): returns (low, high) such
    that :func:`_inv26_1d` reconstructs exactly."""
    x = x.astype(np.int64)
    e, o = x[..., 0::2], x[..., 1::2]
    low = e + o
    n = low.shape[-1]
    high = np.empty_like(low)
    # interior: H = (e - o) - ((L[i-1] - L[i+1] + 4) >> 3)
    high[..., 1:-1] = (e[..., 1:-1] - o[..., 1:-1]) - (
        (low[..., :-2] - low[..., 2:] + 4) >> 3)
    # borders are anchored to the decoder's 11/-4/1 and 5/4/-1 taps
    tmp0 = (11 * low[..., 0] - 4 * low[..., 1] + low[..., 2] + 4) >> 3
    high[..., 0] = 2 * e[..., 0] - tmp0
    tmpn = (5 * low[..., n - 1] + 4 * low[..., n - 2] - low[..., n - 3] + 4) >> 3
    high[..., n - 1] = 2 * e[..., n - 1] - tmpn
    return low, high


def _inv26_1d(low: np.ndarray, high: np.ndarray) -> np.ndarray:
    """The libavcodec cfhd reconstruction filter (exact inverse of
    :func:`_fwd26_1d`)."""
    low = low.astype(np.int64)
    high = high.astype(np.int64)
    n = low.shape[-1]
    e = np.empty_like(low)
    o = np.empty_like(low)
    tmp = (low[..., :-2] - low[..., 2:] + 4) >> 3
    e[..., 1:-1] = (tmp + low[..., 1:-1] + high[..., 1:-1]) >> 1
    tmp2 = (low[..., 2:] - low[..., :-2] + 4) >> 3
    o[..., 1:-1] = (tmp2 + low[..., 1:-1] - high[..., 1:-1]) >> 1
    t0 = (11 * low[..., 0] - 4 * low[..., 1] + low[..., 2] + 4) >> 3
    e[..., 0] = (t0 + high[..., 0]) >> 1
    t1 = (5 * low[..., 0] + 4 * low[..., 1] - low[..., 2] + 4) >> 3
    o[..., 0] = (t1 - high[..., 0]) >> 1
    tn0 = (5 * low[..., n - 1] + 4 * low[..., n - 2] - low[..., n - 3] + 4) >> 3
    e[..., n - 1] = (tn0 + high[..., n - 1]) >> 1
    tn1 = (11 * low[..., n - 1] - 4 * low[..., n - 2] + low[..., n - 3] + 4) >> 3
    o[..., n - 1] = (tn1 - high[..., n - 1]) >> 1
    out = np.empty(low.shape[:-1] + (2 * n,), np.int64)
    out[..., 0::2] = e
    out[..., 1::2] = o
    return out


def _fwd26_2d(p: np.ndarray):
    """One level: horizontal then vertical -> (LL, HL, LH, HH)."""
    lo, hi = _fwd26_1d(p)
    ll, lh = (a.swapaxes(-1, -2) for a in _fwd26_1d(lo.swapaxes(-1, -2)))
    hl, hh = (a.swapaxes(-1, -2) for a in _fwd26_1d(hi.swapaxes(-1, -2)))
    return ll, hl, lh, hh


def _inv26_2d(ll, hl, lh, hh):
    lo = _inv26_1d(ll.swapaxes(-1, -2), lh.swapaxes(-1, -2)).swapaxes(-1, -2)
    hi = _inv26_1d(hl.swapaxes(-1, -2), hh.swapaxes(-1, -2)).swapaxes(-1, -2)
    return _inv26_1d(lo, hi)


# ---------------------------------------------------------------------------
# sample container
# ---------------------------------------------------------------------------


def _tag(t: int, v: int) -> bytes:
    return struct.pack(">hH", t, v & 0xFFFF)


# per-level prescale shifts, coarsest first (PrescaleTable 0x2000 = shift 2
# on the last forward level, like the libavcodec encoder emits)
_PRESCALE = (2, 0, 0)

# level companding for the run/level codebook (calibrated against the
# libavcodec decoder with multi-quant probe streams: cubic
# decompand(L) = L + (768*L^3 >> 24) — near identity below ~L=50,
# superlinear above; validated by whole-stream agreement with lavc's
# decode to a few codes across the quality range, the residue being
# synthesis rounding noise, not curve error)
_DECOMPAND = np.arange(256, dtype=np.int64)
_DECOMPAND = _DECOMPAND + (768 * _DECOMPAND ** 3 >> 24)


def decompand_levels(levels: np.ndarray) -> np.ndarray:
    a = np.abs(levels)
    return np.sign(levels) * _DECOMPAND[np.clip(a, 0, 255)]


def _quantize(band: np.ndarray, quant: int) -> np.ndarray:
    """coefficient -> companded level: nearest level L such that
    decompand(L)*quant approximates the coefficient."""
    b = band.astype(np.int64)
    mag = (np.abs(b) + quant // 2) // quant
    lvl = np.searchsorted(_DECOMPAND, np.clip(mag, 0, _DECOMPAND[-1]))
    # searchsorted gives first L with decompand >= mag; pick closer of L-1/L
    lvl = np.clip(lvl, 0, 255)
    lo = np.clip(lvl - 1, 0, 255)
    pick_lo = (np.abs(_DECOMPAND[lo] - mag) <= np.abs(_DECOMPAND[lvl] - mag))
    lvl = np.where(pick_lo, lo, lvl)
    return np.sign(b) * lvl


class CfhdEncoder:
    """UYVY -> CFHD sample stream (3-channel 4:2:2, 10-bit internal)."""

    def __init__(self, width: int, height: int, quality: int = 90):
        if width % 16 or height % 8:
            raise ValueError("CFHD needs width % 16 == 0 and height % 8 == 0")
        self.width, self.height = width, height
        # per-band quantisers (coarsest wavelet first; index 0 unused for
        # the lowpass which is stored raw): modest defaults; higher
        # quality -> smaller quants
        q = max(1, (100 - quality) // 8)
        self.quants = [
            [4 * q, 4 * q, 8 * q],      # wavelet 3 (coarsest) bands 1..3
            [8 * q, 8 * q, 16 * q],     # wavelet 2
            [12 * q, 12 * q, 24 * q],   # wavelet 1 (finest)
        ]

    # -- channel encode ---------------------------------------------------

    def _encode_channel(self, plane10: np.ndarray, chan: int) -> bytes:
        # forward transform with the PrescaleTable-0x2000 semantics the
        # libavcodec decoder applies on reconstruction: the finest-level
        # lowpass is down-shifted by 2 BEFORE the middle analysis (the
        # decoder up-shifts its middle-synthesis output by 2 before the
        # finest synthesis — single-coefficient probes show subbands 4-6
        # reconstruct 4x relative to 7-9), keeping intermediates in int16
        levels = []
        cur = plane10.astype(np.int64)
        for lvl in range(3):
            if lvl == 1:
                cur = cur >> 2  # prescale boundary (table 0x2000)
            ll, hl, lh, hh = _fwd26_2d(cur)
            levels.append((hl, lh, hh))
            cur = ll
        lowpass = cur
        out = bytearray()
        w3, h3 = lowpass.shape[1], lowpass.shape[0]
        out += _tag(4, 0x1A4A)
        out += _tag(25, 0)        # lowpass subband index
        out += _tag(26, 3)        # number of wavelet levels
        out += _tag(27, w3)
        out += _tag(28, h3)
        out += _tag(33, 0)
        out += _tag(34, 1)        # lowpass quantisation
        out += _tag(35, 16)       # lowpass precision (bits)
        out += _tag(4, 0x0F0F)
        out += np.clip(lowpass, 0, 65535).astype(">u2").tobytes()
        out += _tag(4, 0x1B4B)    # end of lowpass section
        subband = 1
        # (37, 38, 39) triplets exactly as the libavcodec encoder emits
        # them: wavelet type/number/level per level, coarsest first
        wavelet_tags = ((3, 3, 3), (3, 2, 2), (5, 1, 1))
        for wl in range(3):       # coarsest (wavelet 3) first
            hl, lh, hh = levels[2 - wl]
            bh, bw = hl.shape
            out += _tag(4, 0x0D0D)
            t37, t38, t39 = wavelet_tags[wl]
            out += _tag(37, t37)
            out += _tag(38, t38)
            out += _tag(39, t39)
            out += _tag(40, 4)
            out += _tag(41, bw)
            out += _tag(42, bh)
            out += _tag(43, 0)
            out += _tag(44, 0)
            out += _tag(45, 1)
            out += _tag(46, 1)
            for bi, band in enumerate((hl, lh, hh)):
                quant = self.quants[wl][bi]
                coeffs = _quantize(band, quant)
                data = encode_band(coeffs)
                out += _tag(4, 0x0E0E)
                out += _tag(48, bi + 1)   # subband number within wavelet
                out += _tag(72, 1)
                out += _tag(49, bw)
                out += _tag(50, bh)
                out += _tag(51, subband)  # global subband counter
                out += _tag(52, 3)      # band encoding: run/level codebook
                out += _tag(53, quant)
                out += _tag(54, 1)
                out += _tag(55, 0)      # band header end; data follows
                out += data
                out += _tag(56, 0)      # band trailer
                subband += 1
        return bytes(out)

    def encode_uyvy(self, frame: np.ndarray) -> bytes:
        f = np.asarray(frame, np.uint8)
        y = f[:, 1::2].astype(np.int64) << 2
        u = f[:, 0::4].astype(np.int64) << 2
        v = f[:, 2::4].astype(np.int64) << 2
        # CFHD channel order is Y, V, U (lavc maps channel 1 -> Cr)
        chans = [self._encode_channel(p, i) for i, p in enumerate((y, v, u))]
        hdr = bytearray()
        hdr += _tag(1, 9)                 # sample type
        hdr += _tag(2, 3)                 # sample index: 3 entries
        # per-channel section byte sizes (used by the decoder to locate
        # each plane; channel 0 carries no channel-prefix tags)
        for i, c in enumerate(chans):
            sz = len(c) + (0 if i == 0 else 12)
            hdr += _tag(0, sz)
        hdr += _tag(10, 0)                # transform type: spatial
        hdr += _tag(11, 1)                # num frames
        hdr += _tag(12, 3)                # channel count
        hdr += _tag(84, 1)                # encoded format: YUV 4:2:2
        hdr += _tag(13, 3)                # wavelet count
        hdr += _tag(14, 10)               # subband count
        hdr += _tag(15, 2)
        hdr += _tag(16, 3)
        hdr += _tag(20, self.width)
        hdr += _tag(21, self.height)
        hdr += _tag(-69, 0)
        hdr += _tag(70, 10)               # precision
        hdr += _tag(83, 0x2000)           # prescale table
        hdr += _tag(68, 1)                # sample flags: progressive
        out = bytearray(hdr)
        for i, c in enumerate(chans):
            if i:
                out += _tag(4, 0x0C0C)
                out += _tag(1, 3)
                out += _tag(62, i)        # channel number
            out += c
        return bytes(out)


def _expected_chan_dims(width: int, height: int, chan: int):
    w = width if chan == 0 else width // 2
    return w, height


def cfhd_decode(stream: bytes, width: int, height: int) -> Optional[List[np.ndarray]]:
    """Decode a CFHD sample (ours or libavcodec's) -> [Y, U, V] 10-bit
    planes (4:2:2)."""
    pos = 0
    n = len(stream)
    chan = 0
    planes: List[Optional[np.ndarray]] = [None, None, None]
    lowpass = None
    bands: List[np.ndarray] = []
    band_dims = None
    low_dims = None
    quants = []
    prescale = 2

    def finish_channel():
        nonlocal lowpass, bands, quants
        if lowpass is None:
            return
        cur = lowpass.astype(np.int64)
        # three levels, coarsest first; the middle-synthesis output is
        # up-shifted by the prescale before the finest synthesis
        for wl in range(3):
            hl, lh, hh = bands[3 * wl:3 * wl + 3]
            q = quants[3 * wl:3 * wl + 3]
            cur = _inv26_2d(cur, decompand_levels(hl) * q[0],
                            decompand_levels(lh) * q[1],
                            decompand_levels(hh) * q[2])
            if wl == 1:
                cur = cur << prescale
        planes[chan] = cur
        lowpass = None
        bands = []
        quants = []

    while pos + 4 <= n:
        tag, val = struct.unpack(">hH", stream[pos:pos + 4])
        pos += 4
        atag = abs(tag)
        if atag == 62:
            finish_channel()
            chan = val
        elif atag == 27:
            low_w = val
        elif atag == 28:
            low_h = val
        elif atag == 49:
            band_w = val
        elif atag == 50:
            band_h = val
        elif atag == 53:
            band_q = val
        elif atag == 83:
            prescale = (val >> 12) & 3
        elif atag == 4 and val == 0x0F0F:
            cnt = low_w * low_h * 2
            lowpass = np.frombuffer(
                stream[pos:pos + cnt], ">u2").astype(np.int64).reshape(low_h, low_w)
            pos += cnt
        elif atag == 55:
            coeffs, bits = decode_band(stream, 8 * pos, band_w * band_h)
            bands.append(coeffs.reshape(band_h, band_w))
            quants.append(band_q)
            pos += (bits + 7) // 8
            pos = (pos + 3) & ~3
    finish_channel()
    if any(p is None for p in planes):
        return None
    return [np.clip(p, 0, 1023) for p in planes]
