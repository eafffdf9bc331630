"""APV-architecture intra codec on tensors (the ``UAPV`` container).

Port of ``ultragrid_tpu/ops/apv.py`` (the reference's ``-c openapv`` role,
src/video_compress/openapv.cpp over liboapv, ISO/IEC 23090-33; the
reference package's codec is a from-scratch tile / DCT / Rice codec of the
same architecture, with no bitstream conformance claimed there or here):

* **Intra-only, tile-partitioned frames**, each tile independently
  decodable.
* **8x8 block DCT and flat quantisation** (qp 0..63, the step doubling
  every 6 qp) on the codec's device, float32.
* **Quantised-DC prediction and a Golomb-Rice entropy layer** in five
  structure-of-arrays token planes: host numpy, copied as is.

Bit-equality of the float32 transform.  ``jnp.round(c * inv_step)``
decides a level on an exact .5, so the summation order of the DCT decides
levels.  XLA compiles the reference's forward einsum ``"ij,njk,lk->nil"``
for the CPU into two dots of K = 8, each ``f32[8n, 8] x f32[8, 8]`` at
``Precision.HIGHEST``, the basis a constant: the first sums over j (rows
(n, k), then a transpose to rows (n, i)), the second over k; the inverse
``"ji,njk,kl->nil"`` likewise over j, then k.  XLA's CPU dot of K = 8 does
not sum in ascending order: it keeps four partial sums, partial r the fused
multiply-add chain over terms r and r + 4, and adds them as (p0 + p1) +
(p2 + p3), at every row count down to one block (8 rows).  Each 8-term sum
is written here in that order with ``_kutils.fma`` (:func:`_sum8`), on the
CPU and on the card alike (never ``torch.matmul``, whose order on the card
differs); ``tests/test_torch_apv.py`` holds levels and samples equal to the
reference's from 1 block up, with no tolerance.

The device/host split: a plane goes to the device once (10-bit widening
and padding there), its levels come back in one copy; on decode the levels
of a plane go up in one copy and the inverse, the clip and the crop run on
the device.
"""

from __future__ import annotations

import struct
from functools import lru_cache
from typing import List, Sequence

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, on_device
from ultragrid_tpu_torch.ops._kutils import fma
from ultragrid_tpu_torch.ops.jpeg import ZIGZAG
from ultragrid_tpu_torch.ops.jpegxs import _BitReader, _BitWriter, pad_edge

MAGIC = b"UAPV"
_MB = 16  # tile alignment unit (luma px), the spec's macroblock

# orthonormal 8-point DCT-II basis (f64-accurate constants, applied in f32)
_N = 8
_DCT = np.zeros((_N, _N))
for _k in range(_N):
    _c = np.sqrt((1 if _k == 0 else 2) / _N)
    _DCT[_k] = _c * np.cos((2 * np.arange(_N) + 1) * _k * np.pi / (2 * _N))
_DCT_F32 = _DCT.astype(np.float32)


def qp_to_step(qp: int) -> float:
    """Quantizer step in (10-bit) pixel-domain units; doubles every 6 qp."""
    return 0.625 * 2.0 ** (qp / 6.0)


# ---------------------------------------------------------------------------
# device transform + quant
# ---------------------------------------------------------------------------


def _blockify(plane: torch.Tensor) -> torch.Tensor:
    h, w = plane.shape
    return plane.reshape(h // _N, _N, w // _N, _N).permute(0, 2, 1, 3).reshape(-1, _N, _N)


def _unblockify(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return blocks.reshape(h // _N, w // _N, _N, _N).permute(0, 2, 1, 3).reshape(h, w)


def _sum8(term) -> torch.Tensor:
    """sum_{k < 8} a_k * b_k for ``term(k) = (a_k, b_k)`` in the order of
    XLA's CPU dot of K = 8: four partial sums, partial r the fused
    multiply-add chain over k = r then k = r + 4, joined as (p0 + p1) +
    (p2 + p3)."""
    parts = []
    for r in range(4):
        a, b = term(r)
        acc = a * b
        a, b = term(r + 4)
        parts.append(fma(a, b, acc))
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _two_dots(x: torch.Tensor, first: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """out[n, i, l] = sum_k (sum_j first[i, j] x[n, j, k]) second[k, l], each
    sum in the order of XLA's CPU dot (:func:`_sum8`)."""
    y = _sum8(lambda j: (first[:, j].view(1, _N, 1), x[:, j, :].unsqueeze(1)))
    return _sum8(lambda k: (y[:, :, k].unsqueeze(2), second[k, :].view(1, 1, _N)))


@lru_cache(maxsize=None)
def _basis(device: torch.device) -> torch.Tensor:
    """The DCT basis on ``device``, uploaded once."""
    return torch.as_tensor(_DCT_F32, device=device)


def forward_levels(plane: torch.Tensor, center: int, inv_step: float) -> torch.Tensor:
    """The reference's ``_fwd_fn``: an int plane (whole 8x8 blocks) ->
    int32 levels [blocks, 64], raster block order."""
    t = _basis(plane.device)
    x = _blockify(plane.to(torch.float32) - center)
    c = _two_dots(x, t, t.T)  # sum_j t[i, j] x[n, j, k], then sum_k y[n, i, k] t[l, k]
    return torch.round(c * float(np.float32(inv_step))).to(torch.int32).reshape(-1, 64)


def inverse_levels(levels: torch.Tensor, center: int, maxval: int, step: float) -> torch.Tensor:
    """The reference's ``_inv_fn``: int levels [blocks, 64] -> int32 samples
    [blocks, 64]."""
    t = _basis(levels.device)
    c = (levels.to(torch.float32) * float(np.float32(step))).reshape(-1, _N, _N)
    x = _two_dots(c, t.T, t)  # sum_j t[j, i] c[n, j, k], then sum_k z[n, i, k] t[k, l]
    x = torch.round(x) + center
    return torch.clamp(x, 0, maxval).to(torch.int32).reshape(-1, 64)


# ---------------------------------------------------------------------------
# vectorized Rice layer (host; a copy of the reference's)
# ---------------------------------------------------------------------------


def _rice_k(vals: np.ndarray) -> int:
    """Optimal k (total-bits argmin) with the unary part capped <= 40."""
    if vals.size == 0:
        return 0
    vmax = int(vals.max())
    best_k, best_cost = 0, None
    for k in range(18):
        if (vmax >> k) > 40:
            continue
        cost = int((vals >> k).sum()) + vals.size * (k + 1)
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
    if best_cost is None:  # pathological: huge values; k=24 always fits 10/12-bit levels
        best_k = 24
    return best_k


def _rice_put(bw: _BitWriter, vals: np.ndarray, k: int) -> None:
    """Rice-code vals (uint) with parameter k: q zeros, '1', k LSBs.

    One token is emitted as the (q+1+k)-bit MSB-first word (1<<k)|rem —
    its leading zeros ARE the unary part, so a single put_bits_vec call
    emits the whole plane."""
    vals = np.asarray(vals, np.uint64)
    q = vals >> k
    rem = vals & ((1 << k) - 1)
    bw.put_bits_vec((np.uint64(1) << np.uint64(k)) | rem, q + 1 + k)


def _rice_decode_vec(br: _BitReader, n: int, k: int) -> np.ndarray:
    """Decode n Rice(k) tokens with pointer-doubling over the ones index.

    Token i ends at the first set bit at/after its start plus k suffix
    bits, so "terminator index -> next terminator index" is a pure
    function f over the precomputed ones array; the token sequence is
    the orbit of f from the current position, computed in O(n log n)
    vector gathers instead of a serial scan."""
    if n == 0:
        return np.zeros(0, np.int64)
    ones, bits = br._ones, br.bits
    j0 = int(np.searchsorted(ones, br.pos))
    # f[j]: index of the terminator following terminator j (k suffix bits later)
    f = np.searchsorted(ones, ones + 1 + k).astype(np.int64)
    f = np.concatenate([f, [len(ones)]])  # sentinel self-loop for stream end
    orbit = np.empty(n, np.int64)
    orbit[0] = j0
    m, F = 1, f
    while m < n:
        take = min(m, n - m)
        orbit[m : m + take] = F[orbit[:take]]
        m *= 2
        if m < n:
            F = F[F]  # f^(2^t) by self-composition
    term = ones[orbit]
    starts = np.concatenate([[br.pos], term[:-1] + 1 + k])
    q = (term - starts).astype(np.int64)
    rem = np.zeros(n, np.int64)
    for b in range(k):
        rem = (rem << 1) | bits[term + 1 + b]
    br.pos = int(term[-1]) + 1 + k
    return (q << k) | rem


def _smap(v: np.ndarray) -> np.ndarray:
    """signed -> unsigned interleave (0,-1,1,-2,2 -> 0,1,2,3,4 style)."""
    return np.where(v > 0, 2 * v - 1, -2 * v).astype(np.int64)


def _sunmap(z: np.ndarray) -> np.ndarray:
    return np.where(z & 1, (z + 1) >> 1, -(z >> 1)).astype(np.int64)


# ---------------------------------------------------------------------------
# per-tile-component entropy coding
# ---------------------------------------------------------------------------


def _encode_tile_comp(lv: np.ndarray) -> bytes:
    """lv: [nblocks, 64] int32 quantized levels (tile raster order)."""
    dc = lv[:, 0].astype(np.int64)
    dcd = _smap(np.diff(dc, prepend=0))
    ac = lv[:, ZIGZAG][:, 1:].astype(np.int64)  # zigzag-ordered AC, 63/block
    mask = ac != 0
    nnz = mask.sum(axis=1).astype(np.int64)
    idx = np.flatnonzero(mask.reshape(-1))
    bid = idx // 63
    pos = idx % 63
    prev = np.concatenate([[-1], pos[:-1]])
    first = np.concatenate([[True], bid[1:] != bid[:-1]])
    runs = np.where(first, pos, pos - prev - 1).astype(np.int64)
    vals = ac.reshape(-1)[idx]
    mags = np.abs(vals) - 1
    signs = (vals < 0).astype(np.uint64)

    ks = [_rice_k(a) for a in (dcd, nnz, runs, mags)]
    bw = _BitWriter()
    for a, k in zip((dcd, nnz, runs, mags), ks):
        if a.size:
            _rice_put(bw, a, k)
    if signs.size:
        bw.put_bits_vec(signs, np.ones(signs.size, np.int64))
    payload = bw.tobytes()
    return struct.pack("<I4B", len(payload), *ks) + payload


def _decode_tile_comp(data: bytes, off: int, nb: int):
    size, k_dc, k_nnz, k_run, k_ac = struct.unpack_from("<I4B", data, off)
    off += 8
    br = _BitReader(data[off : off + size])
    dc = np.cumsum(_sunmap(_rice_decode_vec(br, nb, k_dc)))
    nnz = _rice_decode_vec(br, nb, k_nnz)
    total = int(nnz.sum())
    runs = _rice_decode_vec(br, total, k_run)
    mags = _rice_decode_vec(br, total, k_ac) + 1
    signs = br.take(np.ones(total, np.int64)) if total else np.zeros(0, np.uint64)
    lv = np.zeros((nb, 64), np.int64)
    lv[:, 0] = dc
    if total:
        bid = np.repeat(np.arange(nb), nnz)
        starts_tok = np.concatenate([[0], np.cumsum(nnz)])[:-1]
        cs = np.cumsum(runs + 1)
        base = np.where(starts_tok > 0, cs[starts_tok - 1], 0)
        pos = cs - base[bid] - 1
        zz = np.zeros((nb, 63), np.int64)
        zz[bid, pos] = np.where(signs.astype(bool), -mags, mags)
        lv[:, ZIGZAG[1:]] = zz
    return lv, off + size


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


def _pad_to(plane: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    h, w = plane.shape
    return pad_edge(plane, h + (-h) % mh, w + (-w) % mw)


def _even_split(n: int, parts: int) -> List[int]:
    """Bounds of n units split into `parts` near-even chunks."""
    base, extra = divmod(n, parts)
    bounds = [0]
    for i in range(parts):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return bounds


class ApvCodec:
    """Encoder/decoder over planar components (8..12-bit content), the
    transform on ``device`` (the card unless the caller names another).

    qp: 0 (near-lossless) .. 63; chroma uses qp + chroma_qp_offset.
    Tile grid defaults to ~1920x1080-luma tiles (MB-aligned), the spec's
    independently-decodable-region role.
    """

    def __init__(self, qp: int = 18, bit_depth: int = 10,
                 chroma_qp_offset: int = 0,
                 tile_w: int = 1920, tile_h: int = 1080, device="cuda"):
        self.qp = int(qp)
        self.bit_depth = int(bit_depth)
        self.chroma_qp_offset = int(chroma_qp_offset)
        self.tile_w, self.tile_h = tile_w, tile_h
        self.device = get_device(device)

    def analyse(self, plane: torch.Tensor, ci: int, sub: int) -> np.ndarray:
        """The device stage of the encoder: component ``ci`` (chroma
        subsampled horizontally by ``sub``) padded to whole macroblocks,
        through the transform and quantiser on the codec's device, its
        levels [block rows, block cols, 64] on the host in one copy."""
        pp = _pad_to(plane, _MB, _MB // sub)
        qp = self.qp + (self.chroma_qp_offset if ci else 0)
        step = qp_to_step(min(63, max(0, qp)))
        lv = forward_levels(pp, 1 << (self.bit_depth - 1), 1.0 / step).cpu().numpy()
        return lv.reshape(pp.shape[0] // _N, pp.shape[1] // _N, 64)

    def synthesise(self, lv: np.ndarray, qp: int, bit_depth: int) -> torch.Tensor:
        """The device stage of the decoder: the levels of one component
        [block rows, block cols, 64] uploaded in one copy, through the
        inverse on the codec's device -> its padded int32 plane."""
        step = qp_to_step(min(63, max(0, qp)))
        px = inverse_levels(torch.from_numpy(lv.reshape(-1, 64)).to(self.device), 1 << (bit_depth - 1),
                            (1 << bit_depth) - 1, step)
        return _unblockify(px.reshape(-1, _N, _N), lv.shape[0] * _N, lv.shape[1] * _N)

    def encode_planes(self, planes: Sequence) -> bytes:
        """planes: integer arrays or tensors; an array is copied to the
        codec's device, a tensor must be there.  Returns the UAPV stream."""
        planes = [on_device(p, self.device) for p in planes]
        h, w = planes[0].shape
        if len(planes) == 1:
            profile = 0  # 400
        elif planes[1].shape[1] * 2 == planes[0].shape[1]:
            profile = 2  # 422
        else:
            profile = 3  # 444

        # MB-aligned tile grid over the luma geometry
        nmb_w = -(-w // _MB)
        nmb_h = -(-h // _MB)
        cols = _even_split(nmb_w, max(1, min(nmb_w, -(-nmb_w // max(1, self.tile_w // _MB)))))
        rows = _even_split(nmb_h, max(1, min(nmb_h, -(-nmb_h // max(1, self.tile_h // _MB)))))

        head = MAGIC + struct.pack(
            "<BBBBIIHHB", 1, profile, self.bit_depth, self.qp, w, h,
            len(cols) - 1, len(rows) - 1, self.chroma_qp_offset & 0xFF,
        )
        out = [head]
        comp_levels = []
        for ci, p in enumerate(planes):
            sub = 2 if (profile == 2 and ci > 0) else 1
            comp_levels.append((self.analyse(p, ci, sub), sub))

        for r in range(len(rows) - 1):
            for c in range(len(cols) - 1):
                tile = []
                for lv, sub in comp_levels:
                    r0, r1 = rows[r] * 2, rows[r + 1] * 2
                    c0, c1 = cols[c] * (2 // sub), cols[c + 1] * (2 // sub)
                    tile.append(_encode_tile_comp(lv[r0:r1, c0:c1].reshape(-1, 64)))
                blob = b"".join(tile)
                out.append(struct.pack("<I", len(blob)) + blob)
        return b"".join(out)

    def decode_planes(self, stream: bytes) -> List[torch.Tensor]:
        """A UAPV stream -> its int32 planes on the codec's device."""
        assert stream[:4] == MAGIC, "not a UAPV stream"
        (ver, profile, bd, qp, w, h, ntc, ntr, cqo) = struct.unpack_from(
            "<BBBBIIHHB", stream, 4
        )
        assert ver == 1
        cqo = cqo if cqo < 128 else cqo - 256
        nplanes = 1 if profile == 0 else 3
        nmb_w = -(-w // _MB)
        nmb_h = -(-h // _MB)
        cols = _even_split(nmb_w, ntc)
        rows = _even_split(nmb_h, ntr)
        pad_h = nmb_h * _MB

        levels = []
        for ci in range(nplanes):
            sub = 2 if (profile == 2 and ci > 0) else 1
            levels.append(
                (np.zeros((pad_h // _N, nmb_w * _MB // sub // _N, 64), np.int32), sub)
            )
        off = 4 + struct.calcsize("<BBBBIIHHB")
        for r in range(ntr):
            for c in range(ntc):
                off += 4  # tile blob size (redundant with comp sizes)
                for lv, sub in levels:
                    r0, r1 = rows[r] * 2, rows[r + 1] * 2
                    c0, c1 = cols[c] * (2 // sub), cols[c + 1] * (2 // sub)
                    nb = (r1 - r0) * (c1 - c0)
                    block, off = _decode_tile_comp(stream, off, nb)
                    lv[r0:r1, c0:c1] = block.reshape(r1 - r0, c1 - c0, 64)
        return [self.synthesise(lv, qp + (cqo if ci else 0), bd)[:h, : (w // sub if sub == 2 else w)]
                for ci, (lv, sub) in enumerate(levels)]
