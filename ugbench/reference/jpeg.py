"""Plain NumPy JPEG for the benchmark's correctness check.

Independent of the program: the quantisation tables are built here from the
quality the configuration states, the forward and inverse DCT are float64
products, and the entropy decoder reads the file's own markers and tables.

* :func:`forward_coefficients` -- the unrounded quantised DCT coefficients
  of a UYVY frame (4:2:2), zigzag order, blocks in scan order, from
  :func:`blocks_422` and :func:`folded_forward` (which the control,
  ``ugbench/control.py``, computes again in TF32).
* :func:`decode_coefficients` -- baseline Huffman decode of a whole file,
  vectorised over its restart segments (every segment advances one symbol
  per step), to the quantised coefficients.
* :func:`uyvy_pixels` -- the inverse DCT of those coefficients, unrounded,
  clamped to [0, 255], in UYVY byte layout.

Each of the two products also gives a tolerance per value: ``GAMMA`` times
the sum of its terms' magnitudes, a bound on what float32 arithmetic in any
summation order can move it by (64 terms, each rounded twice).  A program
value more than 0.5 plus that from the float64 value is rounded wrongly;
one within it lies on a tie that float32 may round either way.
"""

from __future__ import annotations

import math

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# ITU T.81 Annex K.1, raster order
QUANT_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
QUANT_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, dtype=np.int64)


GAMMA = 2 * 64 * 2.0 ** -24


def quant_tables(quality: int):
    """(luma, chroma) int64 [64] raster tables at ``quality`` (the IJG
    scaling: 5000 / q below 50, 200 - 2 q from 50)."""
    quality = max(1, min(100, int(quality)))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (QUANT_LUMA, QUANT_CHROMA))


def dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II, float64 [8, 8]: X = D x."""
    d = np.zeros((8, 8))
    for k in range(8):
        ck = math.sqrt(0.5) if k == 0 else 1.0
        for n in range(8):
            d[k, n] = 0.5 * ck * math.cos(math.pi * (2 * n + 1) * k / 16.0)
    return d


def _kron64() -> np.ndarray:
    """The 2-D DCT as [64, 64]: flat_out = M @ flat_in (raster both)."""
    d = dct_matrix()
    return np.einsum("ui,vj->uvij", d, d).reshape(64, 64)


def _planes(uyvy: np.ndarray):
    """UYVY [H, 2W] uint8 -> Y [H, W], Cb [H, W/2], Cr [H, W/2]."""
    return uyvy[:, 1::2], uyvy[:, 0::4], uyvy[:, 2::4]


def blocks_422(uyvy: np.ndarray) -> np.ndarray:
    """[nmcu * 4, 64] raster 8x8 blocks in scan order: per 16x8 MCU, Y
    left, Y right, Cb, Cr; MCUs in raster order."""
    h, w2 = uyvy.shape
    w = w2 // 2
    if h % 8 or w % 16:
        raise ValueError(f"4:2:2 blocks need height % 8 == 0 and width % 16 == 0, got {w}x{h}")
    y, cb, cr = _planes(uyvy)
    my, mx = h // 8, w // 16
    yb = y.reshape(my, 8, mx, 2, 8).transpose(0, 2, 3, 1, 4).reshape(my, mx, 2, 64)
    cbb = cb.reshape(my, 8, mx, 8).transpose(0, 2, 1, 3).reshape(my, mx, 1, 64)
    crb = cr.reshape(my, 8, mx, 8).transpose(0, 2, 1, 3).reshape(my, mx, 1, 64)
    return np.concatenate([yb, cbb, crb], axis=2).reshape(-1, 64)


# the component of each block of a 4:2:2 MCU: Y, Y, Cb, Cr (0 luma, 1 chroma)
COMPONENTS_422 = np.array([0, 0, 1, 1])


def folded_forward(quality: int):
    """The forward transform of each component (luma, chroma) as one
    float64 matrix [raster i, zigzag k]: the 2-D DCT, the zigzag and the
    division by the table at ``quality``, so that a block's coefficients
    are ``(block - 128) @ w``."""
    m = _kron64()[ZIGZAG]  # [zigzag k, raster i]
    return tuple((m / q[ZIGZAG][:, None]).T for q in quant_tables(quality))


def forward_coefficients(uyvy: np.ndarray, quality: int):
    """(unrounded quantised coefficients float64 [nmcu * 4, 64], zigzag
    order, of a 4:2:2 JPEG of ``uyvy`` at ``quality``: (x - 128), the 2-D
    DCT and the division by the table in float64; their float32
    tolerances, for a product of the raw bytes with the folded matrix)."""
    blocks = blocks_422(np.asarray(uyvy, np.uint8))
    comp = np.tile(COMPONENTS_422, blocks.shape[0] // 4)
    out = np.empty(blocks.shape, np.float64)
    tol = np.empty(blocks.shape, np.float64)
    for c, w in enumerate(folded_forward(quality)):
        sel = comp == c
        tol[sel] = GAMMA * (blocks[sel].astype(np.float64) @ np.abs(w) + 128.0 * np.abs(w.sum(axis=0)))
        out[sel] = (blocks[sel].astype(np.float64) - 128.0) @ w
    return out, tol


# ---------------------------------------------------------------------------
# Baseline Huffman decode, vectorised over restart segments
# ---------------------------------------------------------------------------


class JpegError(ValueError):
    pass


def parse_headers(data: bytes) -> dict:
    """Markers from SOI to SOS: quantisation tables (raster), Huffman
    tables, restart interval, frame size, the scan's components."""
    if data[:2] != b"\xff\xd8":
        raise JpegError("no SOI")
    pos, qtabs, htabs, ri, comps = 2, {}, {}, 0, []
    h = w = 0
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise JpegError(f"expected a marker at byte {pos}")
        mk = data[pos + 1]
        ln = int.from_bytes(data[pos + 2: pos + 4], "big")
        seg = data[pos + 4: pos + 2 + ln]
        if mk == 0xDB:
            p = 0
            while p < len(seg):
                if seg[p] >> 4:
                    raise JpegError("16-bit quantisation table")
                tab = np.zeros(64, np.int64)
                tab[ZIGZAG] = np.frombuffer(seg[p + 1: p + 65], np.uint8)
                qtabs[seg[p] & 15] = tab
                p += 65
        elif mk == 0xC4:
            p = 0
            while p < len(seg):
                bits = list(seg[p + 1: p + 17])
                vals = list(seg[p + 17: p + 17 + sum(bits)])
                htabs[(seg[p] >> 4, seg[p] & 15)] = (bits, vals)
                p += 17 + sum(bits)
        elif mk == 0xC0:
            h = int.from_bytes(seg[1:3], "big")
            w = int.from_bytes(seg[3:5], "big")
            comps = [{"id": seg[6 + 3 * i], "h": seg[7 + 3 * i] >> 4, "v": seg[7 + 3 * i] & 15,
                      "tq": seg[8 + 3 * i]} for i in range(seg[5])]
        elif mk in (0xC1, 0xC2, 0xC3):
            raise JpegError("not a baseline JPEG")
        elif mk == 0xDD:
            ri = int.from_bytes(seg[:2], "big")
        elif mk == 0xDA:
            scan = []
            for i in range(seg[0]):
                info = next(c for c in comps if c["id"] == seg[1 + 2 * i])
                scan.append({**info, "td": seg[2 + 2 * i] >> 4, "ta": seg[2 + 2 * i] & 15})
            return {"qtabs": qtabs, "htabs": htabs, "ri": ri, "h": h, "w": w, "scan": scan,
                    "scan_start": pos + 2 + ln}
        pos += 2 + ln
    raise JpegError("no SOS")


def _lut(bits, vals):
    """16-bit peek -> (symbol, code length); length 0 marks no code."""
    sym = np.zeros(1 << 16, np.int64)
    ln = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            sym[lo:hi] = vals[k]
            ln[lo:hi] = length
            code += 1
            k += 1
        code <<= 1
    return sym, ln


def _segments(body: np.ndarray):
    """Entropy-coded bytes without stuffing and restart markers, and the
    byte offset at which each restart segment starts in them."""
    ff = np.flatnonzero(body[:-1] == 0xFF)
    nxt = body[ff + 1]
    keep = np.ones(body.size, bool)
    keep[ff[nxt == 0] + 1] = False
    rst = ff[(nxt >= 0xD0) & (nxt <= 0xD7)]
    keep[rst] = False
    keep[rst + 1] = False
    starts = np.zeros(body.size, np.int64)
    starts[rst] = 1
    seg_of = np.cumsum(starts)
    stream = body[keep]
    seg_of = seg_of[keep]
    nseg = rst.size + 1
    first = np.searchsorted(seg_of, np.arange(nseg + 1))
    return stream, first


def decode_coefficients(data: bytes):
    """Baseline Huffman decode of a JPEG file.

    Returns (hdr, coefs int64 [nblocks, 64] zigzag with absolute DC, ok bool
    [nblocks]): blocks in scan order (per MCU each component's h * v
    blocks).  A block of a restart segment that does not decode whole, or
    ends off its segment's last byte, is not ok (its coefficients are 0)."""
    hdr = parse_headers(data)
    scan = hdr["scan"]
    if any(c["v"] != 1 for c in scan):
        raise JpegError("vertical subsampling is not supported here")
    hmax = max(c["h"] for c in scan)
    nmcux = -(-hdr["w"] // (8 * hmax))
    nmcuy = -(-hdr["h"] // 8)
    nmcu = nmcux * nmcuy
    comp_of = np.concatenate([np.full(c["h"], i) for i, c in enumerate(scan)])
    bpm = comp_of.size
    ri = hdr["ri"] or nmcu
    nseg = -(-nmcu // ri)
    raw = np.frombuffer(data, np.uint8)[hdr["scan_start"]:]
    eoi = np.flatnonzero((raw[:-1] == 0xFF) & (raw[1:] == 0xD9))
    if eoi.size == 0:
        raise JpegError("no EOI")
    stream, first = _segments(raw[: eoi[-1]])
    nblocks = nmcu * bpm
    coefs = np.zeros((nblocks, 64), np.int64)
    ok = np.zeros(nblocks, bool)
    if first.size - 1 != nseg:
        return hdr, coefs, ok  # a restart marker missing or extra: nothing is trusted

    luts = [_lut(*hdr["htabs"][key]) for key in sorted(hdr["htabs"])]
    slot = {key: i for i, key in enumerate(sorted(hdr["htabs"]))}
    sym_lut = np.stack([s for s, _ in luts])
    len_lut = np.stack([n for _, n in luts])
    dc_tab = np.array([slot[(0, c["td"])] for c in scan])[comp_of]
    ac_tab = np.array([slot[(1, c["ta"])] for c in scan])[comp_of]
    buf = np.concatenate([stream, np.zeros(4, np.uint8)]).astype(np.int64)

    seg_mcus = np.minimum(ri, nmcu - np.arange(nseg) * ri)
    seg_blocks = seg_mcus * bpm
    base = np.arange(nseg) * ri * bpm
    p = first[:-1] * 8
    blk = np.zeros(nseg, np.int64)
    k = np.zeros(nseg, np.int64)
    live = np.ones(nseg, bool)
    failed = np.zeros(nseg, bool)
    dcdiff = np.zeros(nblocks, np.int64)

    def peek16(pos):
        b = pos >> 3
        word = (buf[b] << 16) | (buf[b + 1] << 8) | buf[b + 2]
        return (word >> (8 - (pos & 7))) & 0xFFFF

    limit = 8 * stream.size
    while True:
        idx = np.flatnonzero(live)
        if idx.size == 0:
            break
        pp, kk, bb = p[idx], k[idx], blk[idx]
        inb = bb % bpm
        isdc = kk == 0
        tab = np.where(isdc, dc_tab[inb], ac_tab[inb])
        word = peek16(np.minimum(pp, limit))
        sym = sym_lut[tab, word]
        ln = len_lut[tab, word]
        s = np.where(isdc, sym, sym & 15)
        r = np.where(isdc, 0, sym >> 4)
        p2 = pp + ln
        val = (peek16(np.minimum(p2, limit)) >> (16 - s)) & ((1 << s) - 1)
        half = np.where(s > 0, 1 << np.maximum(s - 1, 0), 0)
        val = np.where(val < half, val - (1 << s) + 1, val)
        gb = base[idx] + bb
        pos = kk + r
        bad = (ln == 0) | (pp > limit) | (~isdc & (s > 0) & (pos > 63))
        dcdiff[gb[isdc & ~bad]] = val[isdc & ~bad]
        put = ~isdc & (s > 0) & ~bad
        coefs[gb[put], pos[put]] = val[put]
        knew = np.where(isdc, 1, np.where(s > 0, pos + 1, np.where(r == 15, kk + 16, 64)))
        done_blk = knew >= 64
        bb = bb + done_blk
        k[idx] = np.where(done_blk, 0, knew)
        blk[idx] = bb
        p[idx] = p2 + s
        failed[idx[bad]] = True
        live[idx] = ~bad & (bb < seg_blocks[idx])

    # a segment decodes whole and ends in its own last byte (padding < 8 bits)
    end_ok = (p <= first[1:] * 8) & (p > first[1:] * 8 - 8)
    seg_ok = ~failed & end_ok
    block_seg = np.repeat(np.arange(nseg), seg_blocks)
    ok = seg_ok[block_seg]
    # DC: differences within a restart segment, per component
    for c in range(len(scan)):
        sel = np.flatnonzero(comp_of[np.arange(nblocks) % bpm] == c)
        cs = np.cumsum(dcdiff[sel])
        segs = block_seg[sel]
        starts = np.searchsorted(segs, np.arange(nseg))
        before = np.where(starts > 0, cs[np.maximum(starts - 1, 0)], 0)
        coefs[sel, 0] = cs - before[segs]
    coefs[~ok] = 0
    return hdr, coefs, ok


def uyvy_pixels(coefs: np.ndarray, hdr: dict):
    """(unrounded samples float64 [H, 2W] in UYVY byte layout of a 4:2:2
    scan: dequantised with the file's tables, inverse DCT, + 128, clamped
    to [0, 255]; their float32 tolerances in the same layout)."""
    scan = hdr["scan"]
    if [c["h"] for c in scan] != [2, 1, 1]:
        raise JpegError("not a 4:2:2 scan")
    h, w = hdr["h"], hdr["w"]
    my, mx = h // 8, w // 16
    comp = np.tile([0, 0, 1, 2], my * mx)
    minv = _kron64()[ZIGZAG]  # [zigzag k, raster i]: x = X @ M (orthonormal)
    px = np.empty(coefs.shape, np.float64)
    tol = np.empty(coefs.shape, np.float64)
    for c in range(3):
        sel = comp == c
        q = hdr["qtabs"][scan[c]["tq"]][ZIGZAG].astype(np.float64)
        wmat = q[:, None] * minv
        tol[sel] = GAMMA * (np.abs(coefs[sel]) @ np.abs(wmat))
        px[sel] = coefs[sel] @ wmat
    return _uyvy_layout(np.clip(px + 128.0, 0.0, 255.0), h, w), _uyvy_layout(tol, h, w)


def _uyvy_layout(blocks: np.ndarray, h: int, w: int) -> np.ndarray:
    """[nmcu * 4, 64] blocks in scan order -> [H, 2W] UYVY byte layout."""
    b = blocks.reshape(h // 8, w // 16, 4, 8, 8)
    out = np.empty((h, 2 * w), np.float64)
    out[:, 1::2] = b[:, :, :2].transpose(0, 3, 1, 2, 4).reshape(h, w)
    out[:, 0::4] = b[:, :, 2].transpose(0, 2, 1, 3).reshape(h, w // 2)
    out[:, 2::4] = b[:, :, 3].transpose(0, 2, 1, 3).reshape(h, w // 2)
    return out
