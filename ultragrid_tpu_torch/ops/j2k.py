"""Own JPEG 2000 (ITU-T T.800) encoder: reversible 5/3 DWT + RCT + EBCOT.

Role: the reference's ``-c cmpto_j2k`` module drives the proprietary
Comprimato SDK (src/video_compress/cmpto_j2k.cpp, 1040 L,
compiled only when the SDK is licensed+present); this is a from-scratch
implementation of the *standard* instead of a wrapper:

* **Reversible 5/3 DWT** (T.800 Annex F): integer lifting with symmetric
  extension, ceil/floor band split, N-level Mallat pyramid, vertical pass
  first.  Lossless.
* **RCT** (reversible color transform, T.800 G.1): exact integer
  RGB<->YCbCr companion to the 5/3 path.
* **EBCOT Tier-1** (T.800 Annex D/C): MQ arithmetic coder + the three
  coding passes per bit-plane, per 64x64 codeblock — implemented in C
  (native/j2k_t1.c) because the coder is bit-serial (same device/host
  split as the JPEG encoder's entropy tail).
* **Tier-2** (T.800 Annex B): tag-tree coded packet headers, LRCP
  progression, single layer, one precinct per resolution; SIZ/COD/QCD
  marker segments.  Rate control = per-band bit-plane truncation
  (quality 100 -> lossless).

The port's copy of ``ultragrid_tpu/ops/j2k.py``: numpy and the shared C
Tier-1 coder on the host, as in the reference; the coder comes from the
port's loader (``ultragrid_tpu_torch.native.j2k_t1_lib``, which raises where
the C file does not build, where the reference's returns None).

Conformance: NOT self-judged — tests decode every emitted codestream with
OpenJPEG (via Pillow) and require byte-exact lossless round-trips.
"""

from __future__ import annotations

import math
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("j2k")

CBSIZE = 64  # codeblock side (xcb = ycb = 6)


# ---------------------------------------------------------------------------
# Reversible 5/3 DWT (T.800 F.4), origin-0 signals
# ---------------------------------------------------------------------------


def _fdwt53_1d(x: np.ndarray, axis: int) -> Tuple[np.ndarray, np.ndarray]:
    """One 5/3 analysis along ``axis``: returns (low[ceil(n/2)], high[floor(n/2)]).

    d[k] = x[2k+1] - floor((x[2k] + x[2k+2]) / 2)
    s[k] = x[2k]   + floor((d[k-1] + d[k] + 2) / 4)
    with whole-sample symmetric extension (x[-1]=x[1], x[n]=x[n-2] =>
    d[-1]=d[0], d[nH]=d[nH-1])."""
    x = np.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if n == 1:
        return np.moveaxis(x.copy(), -1, axis), np.moveaxis(x[..., :0], -1, axis)
    even = x[..., 0::2].astype(np.int32)
    odd = x[..., 1::2].astype(np.int32)
    nL, nH = even.shape[-1], odd.shape[-1]
    if n % 2 == 0:
        ev_next = np.concatenate([even[..., 1:], even[..., -1:]], axis=-1)
    else:
        ev_next = even[..., 1 : nH + 1]
    d = odd - ((even[..., :nH] + ev_next) >> 1)
    if n % 2 == 0:
        d_prev = np.concatenate([d[..., :1], d[..., :-1]], axis=-1)
        d_curr = d
    else:
        d_prev = np.concatenate([d[..., :1], d], axis=-1)
        d_curr = np.concatenate([d, d[..., -1:]], axis=-1)
    s = even + ((d_prev + d_curr + 2) >> 2)
    return np.moveaxis(s, -1, axis), np.moveaxis(d, -1, axis)


def _idwt53_1d(s: np.ndarray, d: np.ndarray, axis: int) -> np.ndarray:
    s = np.moveaxis(s, axis, -1).astype(np.int32)
    d = np.moveaxis(d, axis, -1).astype(np.int32)
    nL, nH = s.shape[-1], d.shape[-1]
    n = nL + nH
    if nH == 0:
        return np.moveaxis(s.copy(), -1, axis)
    if n % 2 == 0:
        d_prev = np.concatenate([d[..., :1], d[..., :-1]], axis=-1)
        d_curr = d
    else:
        d_prev = np.concatenate([d[..., :1], d], axis=-1)
        d_curr = np.concatenate([d, d[..., -1:]], axis=-1)
    even = s - ((d_prev + d_curr + 2) >> 2)
    if n % 2 == 0:
        ev_next = np.concatenate([even[..., 1:], even[..., -1:]], axis=-1)
    else:
        ev_next = even[..., 1 : nH + 1]
    odd = d + ((even[..., :nH] + ev_next) >> 1)
    out = np.empty((*even.shape[:-1], n), np.int32)
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return np.moveaxis(out, -1, axis)


def dwt53_decompose(plane: np.ndarray, levels: int):
    """-> (LL, [(HL, LH, HH) level 1 (finest) .. level N]).  Vertical pass
    first, then horizontal (T.800 F.3: 2D_SD = VER_SD then HOR_SD)."""
    ll = plane.astype(np.int32)
    out = []
    for _ in range(levels):
        lo_v, hi_v = _fdwt53_1d(ll, axis=0)
        ll_, hl = _fdwt53_1d(lo_v, axis=1)
        lh, hh = _fdwt53_1d(hi_v, axis=1)
        out.append((hl, lh, hh))
        ll = ll_
    return ll, out


def dwt53_reconstruct(ll: np.ndarray, details) -> np.ndarray:
    for hl, lh, hh in reversed(details):
        lo_v = _idwt53_1d(ll, hl, axis=1)
        hi_v = _idwt53_1d(lh, hh, axis=1)
        ll = _idwt53_1d(lo_v, hi_v, axis=0)
    return ll


def rct_forward(r: np.ndarray, g: np.ndarray, b: np.ndarray):
    r = r.astype(np.int32); g = g.astype(np.int32); b = b.astype(np.int32)
    y = (r + 2 * g + b) >> 2
    cb = b - g
    cr = r - g
    return y, cb, cr


def rct_inverse(y: np.ndarray, cb: np.ndarray, cr: np.ndarray):
    g = y - ((cb + cr) >> 2)
    r = cr + g
    b = cb + g
    return r, g, b


# ---------------------------------------------------------------------------
# Tier-2: tag trees + bit-stuffed packet header writer (T.800 B.10)
# ---------------------------------------------------------------------------


class _HdrWriter:
    """Packet-header bit writer: MSB first, a 0 bit is stuffed after any
    0xFF byte, and the header may not end on 0xFF."""

    def __init__(self) -> None:
        self.out = bytearray()
        self.cur = 0
        self.ct = 8

    def put_bit(self, b: int) -> None:
        self.cur = (self.cur << 1) | (b & 1)
        self.ct -= 1
        if self.ct == 0:
            self.out.append(self.cur)
            self.ct = 7 if self.cur == 0xFF else 8
            self.cur = 0

    def put_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.put_bit((v >> i) & 1)

    def tobytes(self) -> bytes:
        if self.ct < 8:
            self.out.append((self.cur << self.ct) & 0xFF)
            if self.out[-1] == 0xFF:
                self.out.append(0)
            self.cur = 0
            self.ct = 8
        elif self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTree:
    """2D tag tree (T.800 B.10.2)."""

    def __init__(self, nx: int, ny: int):
        self.dims = []
        while True:
            self.dims.append((nx, ny))
            if nx == 1 and ny == 1:
                break
            nx = (nx + 1) // 2
            ny = (ny + 1) // 2
        self.value = [np.zeros((d[1], d[0]), np.int32) for d in self.dims]
        self.low = [np.zeros((d[1], d[0]), np.int32) for d in self.dims]
        self.known = [np.zeros((d[1], d[0]), bool) for d in self.dims]

    def set_values(self, leaf_values: np.ndarray) -> None:
        self.value[0][...] = leaf_values
        for lvl in range(1, len(self.dims)):
            prev = self.value[lvl - 1]
            nx, ny = self.dims[lvl]
            cur = np.full((ny, nx), np.iinfo(np.int32).max, np.int32)
            for j in range(prev.shape[0]):
                for i in range(prev.shape[1]):
                    jj, ii = j // 2, i // 2
                    cur[jj, ii] = min(cur[jj, ii], prev[j, i])
            self.value[lvl][...] = cur
            self.low[lvl][...] = 0
            self.known[lvl][...] = False
        self.low[0][...] = 0
        self.known[0][...] = False

    def encode(self, bw: _HdrWriter, i: int, j: int, threshold: int) -> None:
        path = []
        lvl = 0
        while True:
            path.append((lvl, i, j))
            if lvl == len(self.dims) - 1:
                break
            lvl += 1
            i //= 2
            j //= 2
        low = 0
        for lvl, ii, jj in reversed(path):  # root -> leaf
            if low > self.low[lvl][jj, ii]:
                self.low[lvl][jj, ii] = low
            else:
                low = int(self.low[lvl][jj, ii])
            val = int(self.value[lvl][jj, ii])
            while low < threshold:
                if low >= val:
                    if not self.known[lvl][jj, ii]:
                        bw.put_bit(1)
                        self.known[lvl][jj, ii] = True
                    break
                bw.put_bit(0)
                low += 1
            self.low[lvl][jj, ii] = low


def _put_numpasses(bw: _HdrWriter, n: int) -> None:
    if n == 1:
        bw.put_bit(0)
    elif n == 2:
        bw.put_bits(0b10, 2)
    elif n <= 5:
        bw.put_bits(0b11, 2)
        bw.put_bits(n - 3, 2)
    elif n <= 36:
        bw.put_bits(0b1111, 4)
        bw.put_bits(n - 6, 5)
    else:
        bw.put_bits(0b111111111, 9)
        bw.put_bits(n - 37, 7)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

_GAIN = {0: 0, 1: 1, 2: 1, 3: 2}  # LL, HL, LH, HH


def _t1_lib():
    from ultragrid_tpu_torch.native import j2k_t1_lib

    return j2k_t1_lib()  # raises where native/j2k_t1.c does not build


def _encode_band_cblks(band: np.ndarray, orient: int, drop: int, mb: int):
    """-> (ncx, ncy, [(zbp, npasses, bytes)]) raster order."""
    lib = _t1_lib()
    h, w = band.shape
    if h == 0 or w == 0:
        return 0, 0, []
    ncx = (w + CBSIZE - 1) // CBSIZE
    ncy = (h + CBSIZE - 1) // CBSIZE
    out = []
    cap = 4 * CBSIZE * CBSIZE + 1024
    buf = np.empty(cap, np.uint8)
    state = np.empty((CBSIZE + 2) * (CBSIZE + 2), np.uint8)
    info = np.zeros(2, np.int32)
    for cy in range(ncy):
        for cx in range(ncx):
            blk = np.ascontiguousarray(
                band[cy * CBSIZE : (cy + 1) * CBSIZE, cx * CBSIZE : (cx + 1) * CBSIZE],
                dtype=np.int32,
            )
            bh, bw_ = blk.shape
            n = lib.j2k_t1_encode_cblk(
                blk.ctypes.data, bw_, bh, orient, drop,
                buf.ctypes.data, cap, state.ctypes.data, info.ctypes.data,
            )
            if n < 0:
                raise RuntimeError("j2k t1 overflow")
            numbps, npasses = int(info[0]), int(info[1])
            zbp = mb - numbps
            if zbp < 0:
                raise RuntimeError(f"j2k: Mb={mb} < numbps={numbps} (raise guard bits)")
            out.append((zbp, npasses, bytes(buf[:n])))
    return ncx, ncy, out


def _packet(subbands) -> bytes:
    """One packet (single layer): subbands = [(ncx, ncy, cblks)]."""
    bw = _HdrWriter()
    empty = all(all(np_ == 0 for _, np_, _ in cb) for _, _, cb in subbands)
    if empty:
        bw.put_bit(0)
        return bw.tobytes()
    bw.put_bit(1)
    bodies = []
    for ncx, ncy, cblks in subbands:
        if not cblks:
            continue
        incl = _TagTree(ncx, ncy)
        imsb = _TagTree(ncx, ncy)
        vals = np.array([0 if np_ > 0 else 1 for _, np_, _ in cblks], np.int32)
        zbps = np.array([z for z, _, _ in cblks], np.int32)
        incl.set_values(vals.reshape(ncy, ncx))
        imsb.set_values(zbps.reshape(ncy, ncx))
        k = 0
        for cy in range(ncy):
            for cx in range(ncx):
                zbp, npasses, body = cblks[k]
                k += 1
                incl.encode(bw, cx, cy, 1)
                if npasses == 0:
                    continue
                imsb.encode(bw, cx, cy, 999)
                _put_numpasses(bw, npasses)
                lblock = 3
                nbits = lblock + int(math.floor(math.log2(npasses)))
                length = len(body)
                while length >= (1 << nbits):
                    bw.put_bit(1)
                    lblock += 1
                    nbits += 1
                bw.put_bit(0)
                bw.put_bits(length, nbits)
                bodies.append(body)
    return bw.tobytes() + b"".join(bodies)


class J2KEncoder:
    """Single-tile, single-layer, LRCP, reversible 5/3 encoder.

    quality: 100 = lossless; below 100 drops low bit-planes per band
    (finest levels first) — EBCOT pass truncation, still a valid stream.
    """

    def __init__(self, levels: int = 5, quality: int = 100, mct: bool = True,
                 guard: int = 2):
        self.levels = levels
        self.quality = quality
        self.mct = mct
        self.guard = guard

    def _drop_for(self, orient: int, level: int) -> int:
        """level: 1 = finest."""
        if self.quality >= 100:
            return 0
        qd = (100 - self.quality + 9) // 10  # 1..10
        if orient == 0:
            return max(0, qd - self.levels)
        return max(0, qd - (level - 1) - (1 if orient in (1, 2) else 0))

    def encode(self, comps: Sequence[np.ndarray], depth: int = 8,
               subsampling: Optional[Sequence[Tuple[int, int]]] = None) -> bytes:
        ncomp = len(comps)
        mct = self.mct and ncomp == 3 and all(c.shape == comps[0].shape for c in comps)
        if subsampling is None:
            subsampling = [(1, 1)] * ncomp
        h0, w0 = comps[0].shape
        xsiz = w0 * subsampling[0][0]
        ysiz = h0 * subsampling[0][1]

        planes = [c.astype(np.int32) - (1 << (depth - 1)) for c in comps]
        if mct:
            planes = list(rct_forward(planes[0], planes[1], planes[2]))

        # Mb baseline shared by all components: worst-case depth+1 (RCT
        # chroma) + gain; decoder only needs Mb >= per-block numbps.
        eps = {o: min(31, depth + 1 + _GAIN[o]) for o in range(4)}
        mb = {o: eps[o] + self.guard - 1 for o in range(4)}

        # decompose + per-resolution subband lists per component
        per_comp = []
        for p in planes:
            ll, details = dwt53_decompose(p, self.levels)
            res = [[(0, ll)]]
            for r in range(1, self.levels + 1):
                lvl = self.levels - r + 1
                hl, lh, hh = details[lvl - 1]
                res.append([(1, hl), (2, lh), (3, hh)])
            per_comp.append(res)

        # packets, LRCP: layer(1) -> resolution -> component
        packets = []
        for r in range(self.levels + 1):
            for c in range(ncomp):
                subs = []
                for orient, band in per_comp[c][r]:
                    level = self.levels if r == 0 else self.levels - r + 1
                    drop = self._drop_for(orient, level)
                    subs.append(_encode_band_cblks(band, orient, drop, mb[orient]))
                packets.append(_packet(subs))
        body = b"".join(packets)

        # markers
        siz = struct.pack(">HIIIIIIIIH", 0, xsiz, ysiz, 0, 0, xsiz, ysiz, 0, 0, ncomp)
        for sx, sy in subsampling:
            siz += struct.pack(">BBB", depth - 1, sx, sy)
        siz = b"\xff\x51" + struct.pack(">H", len(siz) + 2) + siz
        cod = struct.pack(
            ">BBHBBBBBB", 0, 0, 1, 1 if mct else 0, self.levels,
            int(math.log2(CBSIZE)) - 2, int(math.log2(CBSIZE)) - 2, 0, 1,
        )
        cod = b"\xff\x52" + struct.pack(">H", len(cod) + 2) + cod
        sp = [eps[0]] + [eps[o] for _ in range(self.levels) for o in (1, 2, 3)]
        qcd = bytes([self.guard << 5]) + bytes((e << 3) & 0xFF for e in sp)
        qcd = b"\xff\x5c" + struct.pack(">H", len(qcd) + 2) + qcd
        psot = 12 + 2 + len(body)
        sot = b"\xff\x90" + struct.pack(">HHIBB", 10, 0, psot, 0, 1)
        return (b"\xff\x4f" + siz + cod + qcd + sot + b"\xff\x93" + body
                + b"\xff\xd9")


def encode_rgb_lossless(rgb: np.ndarray, levels: int = 5, quality: int = 100) -> bytes:
    """rgb: (h, w, 3) uint8 -> .j2c codestream (RCT + 5/3)."""
    comps = [rgb[:, :, i] for i in range(3)]
    return J2KEncoder(levels=levels, quality=quality, mct=True).encode(comps)


def encode_gray(plane: np.ndarray, levels: int = 5, quality: int = 100) -> bytes:
    return J2KEncoder(levels=levels, quality=quality, mct=False).encode([plane])


# ---------------------------------------------------------------------------
# Decoder (own Tier-2 parse + C Tier-1 decode; no external library)
# ---------------------------------------------------------------------------


class UnsupportedStream(ValueError):
    """Codestream uses features outside the own decoder's profile
    (multi-tile, 9/7, precincts, multi-layer, SOP/EPH)."""


class _HdrReader:
    """Packet-header bit reader with 0xFF unstuffing (mirror of _HdrWriter)."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.cur = 0
        self.ct = 0
        self.prev_ff = False

    def get_bit(self) -> int:
        if self.ct == 0:
            self.cur = self.data[self.pos]
            self.pos += 1
            if self.prev_ff:
                self.ct = 7            # byte after 0xFF carries 7 bits
                self.prev_ff = False   # (its MSB is a stuffed 0)
            else:
                self.ct = 8
                self.prev_ff = self.cur == 0xFF
        self.ct -= 1
        return (self.cur >> self.ct) & 1

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v

    def align(self) -> int:
        """Finish the header: skip padding; a trailing 0xFF carries a
        stuffed 0 byte.  Returns the byte offset after the header."""
        if self.ct == 0 and self.prev_ff:
            self.pos += 1          # stuffing byte after terminal 0xFF
        self.ct = 0
        self.prev_ff = False
        return self.pos


class _TagTreeDec:
    def __init__(self, nx: int, ny: int):
        self.dims = []
        while True:
            self.dims.append((nx, ny))
            if nx == 1 and ny == 1:
                break
            nx = (nx + 1) // 2
            ny = (ny + 1) // 2
        big = 0x7FFFFFFF
        self.value = [np.full((d[1], d[0]), big, np.int64) for d in self.dims]
        self.low = [np.zeros((d[1], d[0]), np.int64) for d in self.dims]

    def decode(self, br: _HdrReader, i: int, j: int, threshold: int) -> bool:
        path = []
        lvl = 0
        while True:
            path.append((lvl, i, j))
            if lvl == len(self.dims) - 1:
                break
            lvl += 1
            i //= 2
            j //= 2
        low = 0
        for lvl, ii, jj in reversed(path):
            if low > self.low[lvl][jj, ii]:
                self.low[lvl][jj, ii] = low
            else:
                low = int(self.low[lvl][jj, ii])
            while low < threshold and low < self.value[lvl][jj, ii]:
                if br.get_bit():
                    self.value[lvl][jj, ii] = low
                else:
                    low += 1
            self.low[lvl][jj, ii] = low
        lvl, ii, jj = path[0]
        return bool(self.value[lvl][jj, ii] < threshold)


def _get_numpasses(br: _HdrReader) -> int:
    if not br.get_bit():
        return 1
    if not br.get_bit():
        return 2
    v = br.get_bits(2)
    if v < 3:
        return 3 + v
    v = br.get_bits(5)
    if v < 31:
        return 6 + v
    return 37 + br.get_bits(7)


class J2KDecoder:
    """Decodes the own encoder's profile (and any codestream within it:
    single tile, reversible 5/3, one layer, default precincts)."""

    def decode(self, cs: bytes) -> List[np.ndarray]:
        if cs[:2] != b"\xff\x4f":
            raise UnsupportedStream("no SOC")
        pos = 2
        xsiz = ysiz = ncomp = None
        depths = []
        subs = []
        levels = None
        mct = 0
        cbw = cbh = None
        guard = eps = None
        while pos < len(cs):
            marker = cs[pos : pos + 2]
            if marker == b"\xff\x93":  # SOD
                pos += 2
                break
            ln = struct.unpack_from(">H", cs, pos + 2)[0]
            seg = cs[pos + 4 : pos + 2 + ln]
            if marker == b"\xff\x51":  # SIZ
                (_, xsiz, ysiz, xo, yo, xt, yt, xto, yto, ncomp) = struct.unpack_from(
                    ">HIIIIIIIIH", seg, 0
                )
                if (xo, yo, xto, yto) != (0, 0, 0, 0) or (xt, yt) != (xsiz, ysiz):
                    raise UnsupportedStream("tiling/offsets")
                off = 36
                for _ in range(ncomp):
                    ssiz, sx, sy = struct.unpack_from(">BBB", seg, off)
                    off += 3
                    if ssiz & 0x80:
                        raise UnsupportedStream("signed components")
                    depths.append((ssiz & 0x7F) + 1)
                    subs.append((sx, sy))
            elif marker == b"\xff\x52":  # COD
                scod, prog, layers, mct, levels, cbw_, cbh_, cbsty, wt = struct.unpack_from(
                    ">BBHBBBBBB", seg, 0
                )
                if scod != 0 or prog != 0 or layers != 1 or cbsty != 0 or wt != 1:
                    raise UnsupportedStream("COD features")
                cbw, cbh = 1 << (cbw_ + 2), 1 << (cbh_ + 2)
            elif marker == b"\xff\x5c":  # QCD
                guard = seg[0] >> 5
                if seg[0] & 0x1F:
                    raise UnsupportedStream("quantization style")
                eps = [b >> 3 for b in seg[1:]]
            elif marker == b"\xff\x90":  # SOT
                pass
            pos += 2 + ln
        if xsiz is None or levels is None or eps is None:
            raise UnsupportedStream("missing markers")

        lib = _t1_lib()

        # band geometry per component
        comp_dims = [((xsiz + sx - 1) // sx, (ysiz + sy - 1) // sy) for sx, sy in subs]

        def band_dims(w, h, levels):
            """[(res, [(orient, bw, bh)])] + final LL dims per level chain."""
            chain = [(w, h)]
            for _ in range(levels):
                w2, h2 = chain[-1]
                chain.append(((w2 + 1) // 2, (h2 + 1) // 2))
            res = [[(0, chain[levels][0], chain[levels][1])]]
            for r in range(1, levels + 1):
                lvl = levels - r + 1
                wl, hl = chain[lvl - 1]
                lw, hw = (wl + 1) // 2, wl // 2
                lh, hh_ = (hl + 1) // 2, hl // 2
                res.append([(1, hw, lh), (2, lw, hh_), (3, hw, hh_)])
            return res

        per_comp_bands = [
            [
                [
                    (orient, np.zeros((bh, bw_), np.int32))
                    for orient, bw_, bh in resbands
                ]
                for resbands in band_dims(w, h, levels)
            ]
            for (w, h) in comp_dims
        ]
        # per-band Mb follows QCD order (LL, then HL,LH,HH per resolution)
        state = np.empty((cbh + 2) * (cbw + 2), np.uint8)

        for r in range(levels + 1):
            for c in range(ncomp):
                br = _HdrReader(cs, pos)
                bodies = []  # (band_idx, cy, cx, numbps, npasses, length)
                if br.get_bit():  # non-empty packet
                    for bi, (orient, band) in enumerate(per_comp_bands[c][r]):
                        bh, bw_ = band.shape
                        if bh == 0 or bw_ == 0:
                            continue
                        ncx = (bw_ + cbw - 1) // cbw
                        ncy = (bh + cbh - 1) // cbh
                        incl = _TagTreeDec(ncx, ncy)
                        imsb = _TagTreeDec(ncx, ncy)
                        qi = 0 if r == 0 else 1 + 3 * (r - 1) + bi
                        mb = eps[qi] + guard - 1
                        lblock = {}
                        for cy in range(ncy):
                            for cx in range(ncx):
                                if not incl.decode(br, cx, cy, 1):
                                    continue
                                zbp = 0
                                while not imsb.decode(br, cx, cy, zbp + 1):
                                    zbp += 1
                                npasses = _get_numpasses(br)
                                lb = lblock.get((cx, cy), 3)
                                while br.get_bit():
                                    lb += 1
                                lblock[(cx, cy)] = lb
                                nbits = lb + int(math.floor(math.log2(npasses)))
                                length = br.get_bits(nbits)
                                bodies.append(
                                    (bi, cy, cx, mb - zbp, npasses, length)
                                )
                pos = br.align()
                for bi, cy, cx, numbps, npasses, length in bodies:
                    orient, band = per_comp_bands[c][r][bi]
                    y0, x0 = cy * cbh, cx * cbw
                    blk_h = min(cbh, band.shape[0] - y0)
                    blk_w = min(cbw, band.shape[1] - x0)
                    coef = np.zeros(blk_h * blk_w, np.int32)
                    data = np.frombuffer(cs, np.uint8, length, pos)
                    lib.j2k_t1_decode_cblk(
                        np.ascontiguousarray(data).ctypes.data, length,
                        blk_w, blk_h, orient, numbps, npasses,
                        coef.ctypes.data, state.ctypes.data,
                    )
                    band[y0 : y0 + blk_h, x0 : x0 + blk_w] = coef.reshape(blk_h, blk_w)
                    pos += length

        # inverse DWT per component
        planes = []
        for c in range(ncomp):
            res = per_comp_bands[c]
            ll = res[0][0][1]
            details = []
            for r in range(1, levels + 1):
                hl, lh, hh = (b for _, b in res[r])
                details.append((hl, lh, hh))
            # res order is coarsest-first; reconstruct wants finest-first
            details.reverse()
            planes.append(dwt53_reconstruct(ll, details))
        if mct and ncomp == 3:
            planes = list(rct_inverse(planes[0], planes[1], planes[2]))
        out = []
        for c, p in enumerate(planes):
            half = 1 << (depths[c] - 1)
            out.append(np.clip(p + half, 0, (1 << depths[c]) - 1).astype(np.uint8))
        return out
