"""The JPEG entropy assembly on the card (``csrc/jpeg_assemble.cu``) and its
plain PyTorch version: kernel K1's per-block slots and bit counts in, the
byte-stuffed entropy-coded scan with its RST markers out, byte-equal to the
host C assembly (``native/jpeg_assemble.c::jpeg_assemble_3c``).

The blocks run in the C code's order: per MCU its ``ky`` luma blocks, then
Cb, then Cr.  Each restart segment of ``restart_interval`` MCUs is filled to
a whole byte with 1-bits, every 0xFF byte of data is followed by 0x00, and
a marker RST((``first_segment`` + s - 1) mod 8) goes before segment s where
``first_segment`` + s > 0: a row band of a frame numbers its markers as
they stand in the frame, so the bands' bodies join as they are.

:class:`Assembly` runs the kernels for CUDA tensors and
:func:`assemble_plain` for CPU ones.  No counterpart in the JAX package,
which assembles the scan on the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ultragrid_tpu_torch import _build

LAUNCHES = _build.LaunchCounter("jpeg_assemble")
EOI = (0xFF, 0xD9)


def stream_order(ys, ybits, us, ubits, vs, vbits, ky: int):
    """(slots int32 [blocks, wwords], bit counts int64 [blocks]) in the
    order the scan holds the blocks, each count cut to its slot's bits."""
    nmcu, ww = us.shape
    slots = torch.cat([ys.reshape(nmcu, ky, ww), us.reshape(nmcu, 1, ww), vs.reshape(nmcu, 1, ww)], 1)
    bits = torch.cat([ybits.reshape(nmcu, ky), ubits.reshape(nmcu, 1), vbits.reshape(nmcu, 1)], 1)
    return slots.reshape(-1, ww), bits.reshape(-1).to(torch.int64).clamp(0, 32 * ww)


def assemble_plain(ys, ybits, us, ubits, vs, vbits, *, ky: int, restart_interval: int,
                   first_segment: int = 0, eoi: bool = False) -> torch.Tensor:
    """The body of the scan as uint8 [n] on the slots' device (the EOI after
    it where ``eoi``): every kept bit placed at its segment's byte offset,
    the pad bits left at 1, then each byte, marker and stuffed 0x00 at its
    place in the output."""
    dev = us.device
    slots, n = stream_order(ys, ybits, us, ubits, vs, vbits, ky)
    nb = slots.shape[0]
    per_seg = (ky + 2) * restart_interval  # blocks a segment
    nseg = -(-nb // per_seg)
    seg_of_block = torch.arange(nb, device=dev) // per_seg
    words = -(-int(n.max()) // 32) if nb else 0
    shifts = torch.arange(31, -1, -1, dtype=torch.int32, device=dev)
    bits = ((slots[:, :words, None] >> shifts) & 1).reshape(nb, 32 * words).to(torch.uint8)
    kept = bits[torch.arange(32 * words, device=dev)[None, :] < n[:, None]]  # the blocks' bits in order

    seg_bits = torch.zeros(nseg, dtype=torch.int64, device=dev).index_add_(0, seg_of_block, n)
    seg_bytes = (seg_bits + 7) // 8
    byte0 = torch.cumsum(seg_bytes, 0) - seg_bytes  # each segment's first byte before stuffing
    bit_seg = torch.repeat_interleave(seg_of_block, n)
    bit_in_seg = torch.arange(kept.numel(), device=dev) - (torch.cumsum(seg_bits, 0) - seg_bits)[bit_seg]
    stream = torch.ones(8 * int(seg_bytes.sum()), dtype=torch.uint8, device=dev)  # pad bits are 1
    stream[8 * byte0[bit_seg] + bit_in_seg] = kept
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=dev)
    data = (stream.reshape(-1, 8).to(torch.int32) * weights).sum(1)

    ff = (data == 0xFF).to(torch.int64)
    byte_seg = torch.repeat_interleave(torch.arange(nseg, device=dev), seg_bytes)
    seg_ff = torch.zeros(nseg, dtype=torch.int64, device=dev).index_add_(0, byte_seg, ff)
    marker = ((first_segment + torch.arange(nseg, device=dev)) > 0).to(torch.int64)
    marks_before = 2 * (torch.cumsum(marker, 0) - marker)  # marker bytes before each segment's own
    total = data.numel() + int(ff.sum()) + 2 * int(marker.sum())
    out = torch.zeros(total + (2 if eoi else 0), dtype=torch.uint8, device=dev)
    # a segment's first byte: its unstuffed offset, the 0xFF bytes before
    # it (each adds a 0x00) and the markers up to its own
    seg_start = byte0 + torch.cumsum(seg_ff, 0) - seg_ff + marks_before + 2 * marker
    at = seg_start[byte_seg] + torch.arange(data.numel(), device=dev) - byte0[byte_seg] + (
        torch.cumsum(ff, 0) - ff - (torch.cumsum(seg_ff, 0) - seg_ff)[byte_seg])
    out[at] = data.to(torch.uint8)
    m = marker.bool()
    idx = torch.arange(nseg, device=dev)[m]
    out[seg_start[m] - 2] = 0xFF
    out[seg_start[m] - 1] = (0xD0 + ((first_segment + idx - 1) & 7)).to(torch.uint8)
    if eoi:
        out[total:] = torch.tensor(EOI, dtype=torch.uint8, device=dev)
    return out


class Assembly:
    """One frame's (or row band's) assembly in two halves around the one
    host read that sizes its output.

    Built from K1's outputs ``(ys, ybits, us, ubits, vs, vbits, overflow)``:
    on the card the count pass and the scan are launched on the current
    stream (the segments' bytes into a scratch buffer, their stuffed
    lengths and offsets, then (length, overflow) in one device word pair);
    on the CPU the plain version runs whole.  :meth:`read` waits for that
    pair; :meth:`write` puts the body, and the EOI where asked, into a
    uint8 tensor of :meth:`read`'s length (+ 2) on the same device."""

    def __init__(self, parts, *, ky: int, restart_interval: int, first_segment: int = 0):
        ys, ybits, us, ubits, vs, vbits, ovf = parts
        self.ky, self.ri, self.first = int(ky), int(restart_interval), int(first_segment)
        self.nmcu, self.ww = us.shape
        self.device = us.device
        self._length = None  # the body's bytes, once read
        if ys.shape != (self.nmcu * self.ky, self.ww) or self.ww > 64 or self.first < 0:
            raise ValueError(f"assembly: slots {tuple(ys.shape)} / {tuple(us.shape)} do not fit ky {ky}")
        if not us.is_cuda:
            self._body = assemble_plain(ys, ybits, us, ubits, vs, vbits, ky=self.ky, restart_interval=self.ri,
                                        first_segment=self.first)
            self._info = (len(self._body), bool(ovf))
            return
        slots = [t.contiguous() for t in (ys, ybits, us, ubits, vs, vbits)]
        for t in slots + [ovf]:
            if t.device != self.device or t.dtype not in (torch.int32, torch.bool):
                raise ValueError(f"assembly: expected int32 slots and counts on {self.device}, got {t.dtype} "
                                 f"on {t.device}")
        nseg = -(-self.nmcu // self.ri)
        dev = self.device
        self._parts = slots  # kept alive until the write pass is enqueued
        self._scratch = torch.empty(nseg * self.ri * (self.ky + 2) * self.ww, dtype=torch.int32, device=dev)
        self._seg_bytes = torch.empty(nseg, dtype=torch.int32, device=dev)
        seg_len = torch.empty(nseg, dtype=torch.int64, device=dev)
        self._offsets = torch.empty(nseg + 1, dtype=torch.int64, device=dev)
        self._info = torch.empty(2, dtype=torch.int64, device=dev)
        ovf = ovf.reshape(1).contiguous()
        lib = _build.kernels_lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.ug_jpeg_assemble_count(
                *(t.data_ptr() for t in slots), ovf.data_ptr(), self.nmcu, self.ky, self.ww, self.ri, self.first,
                self._scratch.data_ptr(), self._seg_bytes.data_ptr(), seg_len.data_ptr(),
                self._offsets.data_ptr(), self._info.data_ptr(), stream)
        _build.check(err, "jpeg_assemble count launch")
        LAUNCHES.add(dev)

    def read(self) -> Tuple[bool, int]:
        """(K1 overflowed, the body's length in bytes): on the card one read
        of the device's pair, which waits for K1 and the count pass."""
        if isinstance(self._info, tuple):
            length, over = self._info
        else:
            length, over = self._info.cpu().tolist()
        self._length = int(length)
        return bool(over), self._length

    def write(self, out: torch.Tensor, eoi: bool = False) -> None:
        """The body (and 0xFF 0xD9 after it where ``eoi``) into ``out``,
        contiguous uint8 of exactly that many bytes on this device."""
        if out.dtype != torch.uint8 or out.dim() != 1 or not out.is_contiguous() or out.device != self.device:
            raise ValueError(f"assembly output: expected contiguous uint8 [n] on {self.device}, got {out.dtype} "
                             f"{tuple(out.shape)} on {out.device}")
        if self._length is None or out.numel() != self._length + (2 if eoi else 0):
            raise ValueError(f"assembly output of {out.numel()} bytes for a body of {self._length} (read first)")
        if self.device.type != "cuda":
            body = self._body
            out[: body.numel()] = body
            if eoi:
                out[body.numel():] = torch.tensor(EOI, dtype=torch.uint8)
            return
        lib = _build.kernels_lib()
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            err = lib.ug_jpeg_assemble_write(
                self._scratch.data_ptr(), self._seg_bytes.data_ptr(), self._offsets.data_ptr(), self.nmcu,
                self.ky, self.ww, self.ri, self.first, int(eoi), out.data_ptr(), stream)
        _build.check(err, "jpeg_assemble write launch")
