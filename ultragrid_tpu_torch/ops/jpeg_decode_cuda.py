"""The JPEG entropy decode on the card (``csrc/jpeg_decode.cu``) and its
plain PyTorch version: a baseline 4:2:2 three-component scan with restart
markers, from the file's bytes to the reverse product's input.

:func:`segment_decode` launches the kernel for a CUDA tensor and runs
:func:`segment_decode_plain` for a CPU one.  Both find the segments at
the file's RST markers and decode each as ``native/jpeg_scan_decode.c``
does, into ``q`` float32 [nmcu, 256], lanes [Y left | Y right | Cb | Cr] x
64 in zigzag order (the layout of ``ops/jpeg.py::packed_coefficients``),
and a status word, int32 [4]: the segments that stopped early, the MCUs
decoded, the RST markers found, 0.  A segment stops where the C
decoder's does: at a code no table holds, a run past coefficient 63, or a
read past its end, except where only the extension of its last symbol is
missing, which both take as 0.  ``JpegDecoder.decode_to_uyvy`` takes this
path on the card for the streams it fits, reads the status once a frame
and raises where it is off, as the C decoder does.  No counterpart in the
JAX package, which decodes the scan on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ultragrid_tpu_torch import _build

LAUNCHES = _build.LaunchCounter("jpeg_decode")
# launches whose status word ``JpegDecoder.decode_to_uyvy`` refused (a scan
# stopped early or the wrong count of restart markers): 0 on any stream the
# port's encoder wrote and the receiver recovered whole
REFUSED = _build.LaunchCounter("jpeg_decode refused")

LUT_BITS = 11
# one Huffman table: lut u32[2048], maxcode i32[18], valoff i32[17], huffval u8[256], pad
TABLE_BYTES = 8592
TILE = 512  # bytes of the scan a warp of the marker kernels reads
PAD = 1024  # bytes the device copy of a file holds past its end: the kernels' aligned loads read there
_COMP_OF_BLOCK = (0, 0, 1, 2)  # MCU block -> component: Y left, Y right, Cb, Cr

# entry flags (csrc/jpeg_decode.cu): the value is not in the entry; the
# symbol has extension bits; the decode stops here
LONG, HAS_EXT, FAIL_BIT = 1 << 12, 1 << 13, 1 << 14
FAIL = FAIL_BIT | 64 << 5


def _extend(x, size):
    """F.2.2.1 EXTEND of the ``size`` extension bits ``x``."""
    half = (1 << size) >> 1
    return x - (x < half) * (2 * half - 1)


def _symbol_entries(n: int, sym: int, ac: bool):
    """(entries, bits the entries are indexed by) for a symbol whose code has
    ``n`` bits.  An entry: bits taken (code and extension) | step to the
    next coefficient << 5 (run + 1; 16 for ZRL; 64 for EOB and any other AC
    symbol of size 0; 0 for DC) | flags | the extension's value as int16 <<
    16.  Where the code and its extension fit in LUT_BITS, one entry per
    extension value; else one LONG entry that holds the code's length and
    the extension's size in place of the value."""
    size = sym & 15 if ac else sym
    step = 0 if not ac else (sym >> 4) + 1 if size else 16 if sym == 0xF0 else 64
    head = (n + size) | step << 5 | (HAS_EXT if size else 0)
    if n + size > LUT_BITS:
        return np.array([head | LONG | n << 16 | size << 21], np.int64), n
    x = np.arange(1 << size, dtype=np.int64)
    return head | (_extend(x, size) & 0xFFFF) << 16, n + size


def huffman_tables(htabs) -> np.ndarray:
    """The four Huffman tables of a header (``_parse_headers``' ``htabs``,
    slot = table id * 2 + class) in the kernel's layout: uint8 [4 * 8592].
    ``lut`` holds, under every 11-bit prefix that starts with a code of at
    most 11 bits, the entry of that code and of its extension's bits
    (:func:`_symbol_entries`), 0 under the others; ``maxcode`` and
    ``valoff`` serve the canonical walk of longer codes, as in
    ``native/jpeg_scan_decode.c``.  A missing table decodes nothing (every
    ``maxcode`` is -1).  Raises ValueError for a table with more codes than
    its lengths hold, and for a DC table with a size above 16 or a code and
    extension of more than 31 bits, which the C decoder reads and an entry
    cannot carry."""
    out = np.zeros((4, TABLE_BYTES), np.uint8)
    for slot in range(4):
        ac = slot % 2 == 1
        lut = np.zeros(1 << LUT_BITS, np.uint32)
        maxcode = np.full(18, -1, np.int32)
        valoff = np.zeros(17, np.int32)
        huffval = np.zeros(256, np.uint8)
        bits, vals = htabs.get((slot % 2, slot // 2), (bytes(16), b""))
        huffval[: len(vals)] = np.frombuffer(vals, np.uint8)[:256]
        code = k = 0
        for n in range(1, 17):
            cnt = bits[n - 1]
            if code + cnt > 1 << n:
                raise ValueError(f"Huffman table {slot}: {cnt} codes of length {n} do not fit")
            for i in range(cnt):
                if not ac and (huffval[(k + i) & 255] > 16 or n + huffval[(k + i) & 255] > 31):
                    raise ValueError(f"Huffman table {slot}: DC size {huffval[(k + i) & 255]} "
                                     f"with a code of {n} bits")
                if n <= LUT_BITS:
                    entries, width = _symbol_entries(n, int(huffval[(k + i) & 255]), ac)
                    base = ((code + i) << (width - n)) << (LUT_BITS - width)
                    lut[base: base + (1 << (LUT_BITS - n))] = np.repeat(entries, 1 << (LUT_BITS - width))
            valoff[n] = k - code
            if cnt:
                maxcode[n] = code + cnt - 1
            code = (code + cnt) << 1
            k += cnt
        maxcode[17] = 0x7FFFFFFF
        row = out[slot]
        row[:8192] = lut.view(np.uint8)
        row[8192:8264] = maxcode.view(np.uint8)
        row[8264:8332] = valoff.view(np.uint8)
        row[8332:8588] = huffval
    return out.reshape(-1)


def _check(file: torch.Tensor, length: int, scan_start: int, tables: torch.Tensor, tds, nmcu: int, ri: int):
    if file.dtype != torch.uint8 or file.dim() != 1 or not file.is_contiguous() or file.numel() < length + PAD:
        raise ValueError(f"file: expected contiguous uint8 [>= {length + PAD}], got "
                         f"{file.dtype} {tuple(file.shape)}")
    if tables.dtype != torch.uint8 or tuple(tables.shape) != (4 * TABLE_BYTES,) or tables.device != file.device:
        raise ValueError(f"tables: expected uint8 [{4 * TABLE_BYTES}] on {file.device}")
    if (not 2 <= scan_start < length or nmcu < 1 or ri < 1 or len(tds) != 3 or any(t not in (0, 1) for t in tds)
            or tds[1] != tds[2]):
        raise ValueError(f"bad scan: start {scan_start} of {length}, {nmcu} MCUs, interval {ri}, tables {tds}")


def _outputs(nmcu: int, nseg: int, ntiles: int, dev: torch.device, out):
    """(q, status, tile counts, segment offsets): ``out``, checked, or new
    tensors.  The counts may hold more than ``ntiles`` entries."""
    if out is None:
        out = (torch.empty(nmcu, 256, dtype=torch.float32, device=dev),
               torch.empty(4, dtype=torch.int32, device=dev),
               torch.empty(ntiles, dtype=torch.int32, device=dev),
               torch.empty(nseg, dtype=torch.int64, device=dev))
    for t, name, dtype, shape in zip(out, ("q", "status", "counts", "off"),
                                     (torch.float32, torch.int32, torch.int32, torch.int64),
                                     ((nmcu, 256), (4,), (max(ntiles, out[2].numel()),), (nseg,))):
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return out


def segment_range(nmcu: int, ri: int, segments=None):
    """(first segment, end segment, MCUs they hold) of a scan of ``nmcu``
    MCUs at restart interval ``ri``: ``segments`` checked, or the whole
    scan."""
    nseg = -(-nmcu // ri)
    seg0, seg1 = (0, nseg) if segments is None else segments
    if not 0 <= seg0 < seg1 <= nseg:
        raise ValueError(f"segments {seg0}-{seg1} of a scan of {nseg}")
    return seg0, seg1, min(seg1 * ri, nmcu) - seg0 * ri


def segment_decode(file: torch.Tensor, length: int, scan_start: int, tables: torch.Tensor, tds,
                   nmcu: int, ri: int, out=None, segments=None):
    """Decode the scan of the JPEG file held in ``file[:length]`` (uint8,
    at least ``length + PAD`` long) from ``scan_start``, the first byte
    after SOS; ``tables`` is :func:`huffman_tables` on the file's device,
    ``tds`` the three components' table ids (the two chroma components'
    the same).  ``segments`` (first, end) decodes those restart segments
    alone (a row band of the frame), the whole scan by default.  Returns (q
    float32 [MCUs of the segments, 256], status int32 [4]) on the file's
    device, without waiting for it: one launch of the kernel on the card,
    the plain version on the CPU.  q is valid where status reads (0, its
    MCUs, ceil(nmcu / ri) - 1, 0): the markers are counted over the whole
    scan.  ``out``: (q, status, int32 [>= the scan's 512-byte tiles],
    int64 [all segments]) to use in place of new tensors."""
    _check(file, length, scan_start, tables, tds, nmcu, ri)
    seg0, seg1, nq = segment_range(nmcu, ri, segments)
    if file.device.type == "cpu":
        return segment_decode_plain(file, length, scan_start, tables, tds, nmcu, ri, out, (seg0, seg1))
    if not file.is_cuda:
        raise ValueError(f"segment_decode: unsupported device {file.device}")
    dev = file.device
    nseg = -(-nmcu // ri)
    ntiles = -(-(length - (scan_start & ~15)) // TILE)
    q, status, counts, off = _outputs(nq, nseg, ntiles, dev, out)
    lib = _build.kernels_lib(keep_gil=True)  # a launch: shorter than a hand-off of the lock
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ug_jpeg_decode(file.data_ptr(), length, scan_start, tables.data_ptr(), tds[0], tds[1], nmcu, ri,
                                 nseg, counts.data_ptr(), ntiles, off.data_ptr(), q.data_ptr(),
                                 status.data_ptr(), seg0, seg1, stream)
    _build.check(err, "jpeg_decode launch")
    LAUNCHES.add(dev)
    return q, status


def upload(host: torch.Tensor, src: np.ndarray, dev: torch.Tensor) -> None:
    """``src`` (uint8) copied into ``host`` (pinned), then one asynchronous
    copy of it to ``dev`` on the card, enqueued on the current stream: one
    call that keeps the interpreter lock."""
    n = src.size
    if (src.dtype != np.uint8 or not src.flags.c_contiguous or host.dtype != torch.uint8 or host.is_cuda
            or host.numel() < n or dev.dtype != torch.uint8 or not dev.is_cuda or dev.numel() < n):
        raise ValueError(f"upload: {n} uint8 bytes into host {host.dtype} [{host.numel()}] "
                         f"and device {dev.dtype} [{dev.numel()}] on {dev.device}")
    with torch.cuda.device(dev.device):
        stream = torch.cuda.current_stream(dev.device).cuda_stream
        err = _build.kernels_lib(keep_gil=True).ug_jpeg_upload(host.data_ptr(), src.ctypes.data, n,
                                                               dev.data_ptr(), stream)
    _build.check(err, "jpeg_decode upload")


def _table_parts(tables: torch.Tensor):
    """(lut, maxcode, valoff, huffval) int64 [4, ...] of :func:`huffman_tables`."""
    t = tables.view(4, TABLE_BYTES)

    def words(a, b, dtype):
        return t[:, a:b].contiguous().view(dtype).to(torch.int64)

    return (words(0, 8192, torch.int32) & 0xFFFFFFFF, words(8192, 8264, torch.int32),
            words(8264, 8332, torch.int32), t[:, 8332:8588].to(torch.int64))


def segment_decode_plain(file: torch.Tensor, length: int, scan_start: int, tables: torch.Tensor, tds,
                         nmcu: int, ri: int, out=None, segments=None):
    """The plain version of :func:`segment_decode`: the same segments, the
    same q and status, in tensor operations.  The segments' symbol chains
    advance together, one symbol of each per step."""
    _check(file, length, scan_start, tables, tds, nmcu, ri)
    seg0, seg1, nq = segment_range(nmcu, ri, segments)
    dev = file.device
    i64 = dict(dtype=torch.int64, device=dev)
    nseg = -(-nmcu // ri)
    q, status = _outputs(nq, nseg, -(-(length - (scan_start & ~15)) // TILE), dev, out)[:2]
    q.zero_()
    status.zero_()

    # the segments: scan_start, then the byte after each RST marker
    b = file[:length].to(torch.int64)
    p = torch.arange(length, **i64)
    nxt = torch.cat([b[1:], b.new_zeros(1)])
    prv = torch.cat([b.new_zeros(1), b[:-1]])
    last = p + 1 >= length
    markers = torch.nonzero((b == 0xFF) & ((nxt & 0xF8) == 0xD0) & ~last & (p >= scan_start)).flatten()
    status[2] = markers.numel()
    if markers.numel() != nseg - 1:
        return q, status
    off = torch.cat([torch.tensor([scan_start], **i64), markers + 2])

    # unstuff: a segment ends at its first 0xFF not followed by 0x00 (or the
    # file's end); a 0x00 after 0xFF inside it is dropped
    ends = torch.nonzero((b == 0xFF) & ((nxt != 0) | last)).flatten()
    seg_end = torch.cat([ends, torch.tensor([length], **i64)])[torch.searchsorted(ends, off)]
    seg_of = torch.searchsorted(off, p, right=True) - 1
    is_start = torch.zeros(length, dtype=torch.bool, device=dev)
    is_start[off] = True
    inside = (seg_of >= 0) & (p < seg_end[seg_of.clamp(min=0)])
    sel = inside & ~((b == 0) & (prv == 0xFF) & ~is_start)
    u = torch.cat([b[sel], b.new_zeros(8)])
    ulen = torch.bincount(seg_of[sel], minlength=nseg)
    ustart = torch.cumsum(ulen, 0) - ulen

    lut, maxcode, valoff, huffval = _table_parts(tables)
    slot_of_block = torch.tensor([2 * tds[c] for c in _COMP_OF_BLOCK], **i64)
    comp_of_block = torch.tensor(_COMP_OF_BLOCK, **i64)
    lens = torch.arange(LUT_BITS + 1, 17, **i64)
    bit_of = torch.arange(17, **i64)
    qf = q.view(-1)

    # the chains of the segments asked for, q's rows from their first MCU
    nlane = seg1 - seg0
    bitpos = ustart[seg0:seg1] * 8
    limit = (ustart + ulen)[seg0:seg1] * 8
    m = torch.arange(seg0, seg1, **i64) * ri
    m_first = m.clone()
    m_end = (m + ri).clamp(max=nmcu)
    blk = torch.zeros(nlane, **i64)
    k = torch.zeros(nlane, **i64)
    pred = torch.zeros(nlane, 3, **i64)
    failed = torch.zeros(nlane, dtype=torch.bool, device=dev)
    active = torch.ones(nlane, dtype=torch.bool, device=dev)
    lane = torch.arange(nlane, **i64)
    while bool(active.any()):
        # 40 bits from the symbol's first byte: <= 7 bits of offset, a code of
        # <= 16 bits, <= 16 bits of extension
        byte = (bitpos >> 3).clamp(max=u.numel() - 5)
        w = (u[byte] << 32) | (u[byte + 1] << 24) | (u[byte + 2] << 16) | (u[byte + 3] << 8) | u[byte + 4]
        sh = bitpos & 7
        peek = (w >> (24 - sh)) & 0xFFFF
        isdc = k == 0
        slot = slot_of_block[blk] + (~isdc).to(torch.int64)
        e = lut[slot, peek >> (16 - LUT_BITS)]
        # where lut has no code, the canonical walk over codes of 12-16 bits
        codes = peek[:, None] >> (16 - lens)
        hit = codes <= maxcode[slot][:, LUT_BITS + 1: 17]
        first = hit.to(torch.int8).argmax(1)
        n_slow = LUT_BITS + 1 + first
        sym_slow = huffval[slot, (codes.gather(1, first[:, None]).squeeze(1) + valoff[slot, n_slow]) & 0xFF]
        size_slow = torch.where(isdc, sym_slow, sym_slow & 15)
        step_slow = torch.where(isdc, 0, torch.where(size_slow != 0, (sym_slow >> 4) + 1,
                                                     torch.where(sym_slow == 0xF0, 16, 64)))
        slow = ((n_slow + size_slow) | step_slow << 5 | LONG | torch.where(size_slow != 0, HAS_EXT, 0)
                | n_slow << 16 | size_slow << 21)
        slow = torch.where(hit.any(1) & (size_slow <= 16) & (n_slow + size_slow <= 31), slow, FAIL)
        e = torch.where(e != 0, e, slow)
        total, step = e & 31, (e >> 5) & 127
        has_ext, is_long = (e & HAS_EXT) != 0, (e & LONG) != 0
        kk = k + step - 1  # the coefficient's place, for a symbol with an extension
        size_long = (e >> 21) & 31
        raw = (w >> (40 - sh - total).clamp(min=0)) & ((1 << size_long) - 1)
        val = torch.where(is_long, _extend(raw, size_long), (((e >> 16) & 0xFFFF) ^ 0x8000) - 0x8000)
        # a code or an extension read past the segment's end stops it, but
        # for the extension of its last symbol alone (coefficient 63 of the
        # last MCU's last block), which reads as 0
        size = torch.where(is_long, size_long, ((val.abs()[:, None] >> bit_of) != 0).sum(1))
        past = bitpos + total > limit
        last_ext = (~isdc & has_ext & (kk == 63) & (blk == 3) & (m == m_end - 1)
                    & (bitpos + total - size <= limit))
        val = torch.where(past, 0, val)
        fail = active & (((e & FAIL_BIT) != 0) | (past & ~last_ext) | (~isdc & has_ext & (kk > 63)))
        ok = active & ~fail
        bitpos = torch.where(ok, bitpos + total, bitpos)
        comp = comp_of_block[blk]
        dc = ok & isdc
        pred[lane[dc], comp[dc]] += val[dc]
        dcv = ((pred[lane, comp] + 32768) & 0xFFFF) - 32768
        ac = ok & ~isdc & has_ext
        row = (m - seg0 * ri) * 256 + blk * 64
        qf[row[dc]] = dcv[dc].to(torch.float32)
        qf[row[ac] + kk[ac]] = val[ac].to(torch.float32)
        k_next = torch.where(isdc, 1, k + step)
        k = torch.where(ok, k_next, k)
        block_done = ok & (k >= 64)
        blk = torch.where(block_done, blk + 1, blk)
        k = torch.where(block_done, 0, k)
        mcu_done = block_done & (blk == 4)
        blk = torch.where(mcu_done, 0, blk)
        m = torch.where(mcu_done, m + 1, m)
        failed |= fail
        active &= ~fail & ~(mcu_done & (m >= m_end))
    status[0] = int(failed.sum())
    status[1] = int((m - m_first).sum())
    return q, status
