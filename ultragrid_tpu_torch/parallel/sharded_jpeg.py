"""Row-sharded JPEG + LDGM: one frame split into row bands over a mesh.

Port of ``ultragrid_tpu/parallel/sharded_jpeg.py``, the analogue of the
reference's tiled-4K/8K mode (ref: src/utils/video.c:67-74, tiles as
independent substreams; src/host.h:98, tiles round-robined over CUDA
devices).  The frame's MCU rows split into one band per device of the
mesh's 'spatial' axis; the restart interval divides the band's MCU count, so
no entropy segment crosses a band and the bands' slots, concatenated, are
bit-identical to a single-device encode of the frame.

:class:`ShardedJpegEncoder` and :class:`ShardedJpegDecoder` are what the
live session runs over ``--param cuda-device`` (``modules/video_compress.py``
and ``modules/video_decompress.py``): the bands live on the cards, and the
wire carries one file a frame, the single-device session's, byte for byte.
The encoder runs each band's K1 (``JpegEncoder._encode``) and its entropy
assembly on its card, one band after the other from the caller's thread,
and copies the bands' bodies into one file on the frame's card; the
decoder decodes each band's restart segments on its card and gathers the
rows onto one device.
The library steps :class:`ShardedSenderStep` and
:class:`ShardedReceiverStep` keep their outputs per band (lists), as a
deployment that sends each band as its own substream would: nothing is
gathered there.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch

from ultragrid_tpu_torch.device import DeviceFile, get_device
from ultragrid_tpu_torch.models.encode import ldgm_container_params
from ultragrid_tpu_torch.ops.fec import Gf2Parity, LdgmSession, build_ldgm_matrix
from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, JpegEncoder, entropy_decode_422
from ultragrid_tpu_torch.parallel.mesh import Mesh, shard_frame_rows
from ultragrid_tpu_torch.types import Codec
from ultragrid_tpu_torch.utils import profiler


def _band_encoder(width: int, height: int, nshards: int, in_codec: Codec, quality: int,
                  restart_interval: Optional[int] = None) -> JpegEncoder:
    """The encoder of one band, its restart interval a divisor of the MCU
    row width so that segments never span bands (ref :43-54); a
    ``restart_interval`` asked for is kept where it divides the band's MCUs."""
    if height % (8 * nshards):
        raise ValueError("height must split into MCU rows per shard")
    local_h = height // nshards
    probe = JpegEncoder(width, local_h, in_codec=in_codec, quality=quality)
    ri = probe.restart_interval
    if restart_interval and probe.nmcu % restart_interval == 0:
        ri = restart_interval
    else:
        while probe.nmcux % ri:
            ri -= 1
    return JpegEncoder(width, local_h, in_codec=in_codec, quality=quality, restart_interval=ri)


def _on(device: torch.device, stream=None):
    """``device`` current (and ``stream`` on it) in this thread, on a card."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    if stream is not None:
        stack.enter_context(torch.cuda.stream(stream))
    return stack


class ShardedJpegEncoder:
    """JPEG encode over the 'spatial' axis of a mesh (rows -> devices).

    :meth:`encode_file` gives the file of a single-device ``JpegEncoder``
    at the band encoder's restart interval, byte for byte, as a uint8
    tensor on the frame's device (:class:`DeviceFile`); :meth:`encode`, as
    a host array.  The frame's rows are copied from its device to the
    bands' (``compress.split``); then each band in turn, on a stream of its
    own on its device (``compress.band``): K1 (``compress.k1``, widened on
    overflow by ``JpegEncoder.encode_into``) and the entropy assembly on the
    card (``compress.assemble``: the count pass, the one read of the band's
    length, the write pass), its restart markers numbered in the frame, the
    marker before its first segment included, and the last band's EOI.  A
    band's host work is a few launches and one read, so the bands run from
    the caller's thread: worker threads a band cost more on the interpreter
    lock than they overlap.  The bands' bodies are then copied after the
    header into one file on the frame's device (over NVLink from the other
    cards), each on its band's stream, which the frame's stream waits for."""

    def __init__(self, width: int, height: int, mesh: Mesh, in_codec: Codec = Codec.UYVY,
                 quality: int = 80, restart_interval: Optional[int] = None):
        self.mesh = mesh
        self.nshards = mesh.shape["spatial"]
        self.devices = mesh.spatial
        self.local = _band_encoder(width, height, self.nshards, in_codec, quality, restart_interval)
        # a whole-frame encoder for the header
        self.full = JpegEncoder(width, height, in_codec=in_codec, quality=quality,
                                restart_interval=self.local.restart_interval, state=self.local.state)
        self._streams = [None] * self.nshards  # a band's stream on its card

    def shard(self, frame) -> List[torch.Tensor]:
        """A frame (array or tensor) -> its row bands, each on its device; a
        list of bands is taken as it is."""
        if isinstance(frame, (list, tuple)):
            return list(frame)
        return shard_frame_rows(frame, self.mesh)

    def encode_device(self, frame) -> List[tuple]:
        """-> per band (ys, ybits, us, ubits, vs, vbits, overflow) on the
        band's device: one K1 launch per band on the card."""
        return [self.local._encode(b) for b in self.shard(frame)]

    def _encode_band(self, s: int, band: torch.Tensor, frame_key) -> torch.Tensor:
        """One band's entropy-coded body on its device, its markers numbered
        in the frame; the last band's ends with the EOI."""
        dev = band.device
        if dev.type == "cuda" and self._streams[s] is None:
            self._streams[s] = torch.cuda.Stream(dev)
        with _on(dev, self._streams[s]), profiler.zone("compress.band", frame=frame_key):
            return self.local.encode_into(band, first_segment=s * self.local.nseg, eoi=s == self.nshards - 1)

    def encode(self, frame) -> np.ndarray:
        """-> the whole frame's JPEG file on the host (:meth:`encode_file`
        copied down)."""
        return np.asarray(self.encode_file(frame))

    def encode_file(self, frame) -> DeviceFile:
        """-> the whole frame's JPEG file on the frame's device (the first
        band's for a list of bands), byte-equal to a single-device
        ``JpegEncoder`` with the same restart interval."""
        with profiler.zone("compress.split"):
            bands = self.shard(frame)
            src = frame.device if isinstance(frame, torch.Tensor) else None
            if src is not None and src.type == "cuda" and any(b.device != src for b in bands):
                # the copies run on the frame's stream: wait for them here
                torch.cuda.current_stream(src).synchronize()
        key = profiler.current_frame()
        bodies = [self._encode_band(s, b, key) for s, b in enumerate(bands)]
        dev = src if src is not None else bands[0].device
        hdr = self.full.header_tensor(dev)
        file = torch.empty(hdr.numel() + sum(b.numel() for b in bodies), dtype=torch.uint8, device=dev)
        file[: hdr.numel()].copy_(hdr, non_blocking=True)
        on_card = dev.type == "cuda"
        # the file's block is free from here on the frame's stream
        placed = torch.cuda.current_stream(dev).record_event() if on_card else None
        off = hdr.numel()
        for s, body in enumerate(bodies):
            with _on(body.device, self._streams[s]):
                if on_card:
                    torch.cuda.current_stream(body.device).wait_event(placed)
                file[off: off + body.numel()].copy_(body, non_blocking=True)
                copied = torch.cuda.current_stream(body.device).record_event() if on_card else None
            if on_card:
                torch.cuda.current_stream(dev).wait_event(copied)
            off += body.numel()
        return file.as_subclass(DeviceFile)


class ShardedJpegDecoder:
    """Receive-side twin of :class:`ShardedJpegEncoder` (ref :127-183): each
    band's decoder takes the restart segments of its MCU rows straight from
    the file, on its device, through ``JpegDecoder``'s card route
    (``JpegDecoder.issue_band``: the file up, the entropy decode of the
    band's segment range, the reverse product of its rows; on the CPU its
    plain version), one band after the other from this thread and none
    waited for until all are enqueued (``decompress.band``).  The file goes
    up to each card from one pinned copy.  The bands are bit-identical to
    the single-device decode's rows.

    :meth:`decode_to_uyvy` keeps the bands on their devices;
    :meth:`decode_frame` gathers them onto ``device`` (``decompress.gather``),
    the display's.  A stream the bands cannot take (not 4:2:2, no restart
    markers, MCU rows or segments that do not split into the bands) takes
    the single-device decode on ``device``."""

    def __init__(self, mesh: Mesh, device=None):
        self.mesh = mesh
        self.nshards = mesh.shape["spatial"]
        self.devices = mesh.spatial
        self.device = self.devices[0] if device is None else get_device(str(device))
        self._single = JpegDecoder(self.device)
        self._bands = [JpegDecoder(d) for d in self.devices]

    def _issue(self, data):
        """Every band's decode enqueued: [(rows, state)], or None where the
        stream needs the single-device decode."""
        issued, pinned = [], None
        for s, (dec, dev) in enumerate(zip(self._bands, self.devices)):
            with _on(dev), profiler.zone("decompress.band"):
                got = dec.issue_band(data, (s, self.nshards), pinned)
            if got is None:
                return None
            issued.append(got)
            if dev.type == "cuda" and pinned is None:
                pinned = dec.staging_host
        return issued

    def _check(self, issued) -> None:
        """Each band's one wait and status check; the first refusal is
        raised once every band has been read."""
        refused = None
        for dec, (_, st) in zip(self._bands, issued):
            try:
                with _on(dec.device):
                    dec.check_band(st)
            except ValueError as e:
                refused = refused or e
        if refused is not None:
            raise refused

    def decode_to_uyvy(self, data):
        """Returns (UYVY row bands [H / n, 2W] uint8, each on its device, h,
        w); a stream the bands cannot take gives the single-device decode,
        one band on ``device``; None where that gives None.  ValueError
        where a band's segments do not decode, as the single-device
        decoder raises."""
        issued = self._issue(data)
        if issued is None:
            res = self._single.decode_to_uyvy(data)
            return None if res is None else ([res[0]], res[1], res[2])
        with profiler.zone("decompress.wait"):
            self._check(issued)
        hdr = issued[0][1].hdr
        return [rows for rows, _ in issued], hdr["h"], hdr["w"]

    def decode_frame(self, data):
        """Returns (UYVY uint8 [nmcuy * 8, nmcux * 32] on ``device``, h, w),
        the bands copied there in order, or the single-device decode; None
        and ValueError as :meth:`decode_to_uyvy`."""
        issued = self._issue(data)
        if issued is None:
            return self._single.decode_to_uyvy(data)
        with profiler.zone("decompress.gather"):
            first = issued[0][0]
            out = torch.empty(first.shape[0] * len(issued), first.shape[1], dtype=first.dtype,
                              device=self.device)
            for s, (rows, _) in enumerate(issued):
                out[s * rows.shape[0]: (s + 1) * rows.shape[0]].copy_(rows, non_blocking=True)
        with profiler.zone("decompress.wait"):
            self._check(issued)
        hdr = issued[0][1].hdr
        return out, hdr["h"], hdr["w"]


def slot_container_geometry(local: JpegEncoder, k: int):
    """LDGM container geometry of one band's slot container (ref :186-204):
    the six slot parts (Y/U/V slot words and bit counts), each padded to
    whole ``ps``-byte symbol rows, concatenated.  Returns (ps, row_counts,
    part_words)."""
    ww = local.wwords
    n_y, n_c = local.nmcu * local.ky, local.nmcu
    part_words = [n_y * ww, n_y, n_c * ww, n_c, n_c * ww, n_c]
    ps, _ = ldgm_container_params(sum(part_words) * 4, k)
    while sum(-(-(w * 4) // ps) for w in part_words) > k:
        ps += 4
    row_counts = [-(-(w * 4) // ps) for w in part_words]
    return ps, row_counts, part_words


class ShardedSenderStep:
    """The multi-device sender step (ref :207-286): per band, JPEG encode
    (K1) and LDGM parity (K2, staircase on) over that band's slot container,
    on the band's device.  Every output stays per band, as for a
    deployment that sends each band as an RTP substream of its own (ref:
    tiled substream IDs, src/transmit.c:490); the live session sends one
    file a frame instead (:class:`ShardedJpegEncoder`).

    ``step(frame)`` returns one tuple per band, as ``EncodePipeline``'s JPEG
    + LDGM step: (ys, ybits, us, ubits, vs, vbits, parity uint8 [m, ps],
    overflow).  Each band's outputs are bit-identical to a single-device
    encode of that band plus the parity of its container.
    """

    def __init__(self, width: int, height: int, mesh: Mesh, in_codec: Codec = Codec.UYVY,
                 quality: int = 80, k: int = 32, m: int = 8, c: int = 3):
        self.base = ShardedJpegEncoder(width, height, mesh, in_codec, quality)
        self.mesh = mesh
        self.k, self.m, self.c = k, m, c
        self.ps, self.row_counts, self.part_words = slot_container_geometry(self.base.local, k)
        self.mask = build_ldgm_matrix(k, m, c, 1)
        # the container's rows past the six parts are zero and add nothing:
        # the parity over the parts' rows is the full mask's
        self.parity = Gf2Parity(self.mask[:, : sum(self.row_counts)], self.ps // 4,
                                part_words=self.part_words)

    def __call__(self, frame) -> List[tuple]:
        out = []
        for ys, ybits, us, ubits, vs, vbits, ovf in self.base.encode_device(frame):
            par = self.parity(ys, ybits, us, ubits, vs, vbits)
            out.append((ys, ybits, us, ubits, vs, vbits, par.view(torch.uint8).reshape(self.m, self.ps), ovf))
        return out


def band_symbols(band_out, row_counts, ps: int, k: int) -> np.ndarray:
    """One band's sender outputs -> its ``[k + m, ps]`` wire symbols on the
    host: the six parts, each zero-padded to its rows, zero rows to ``k``,
    then the parity."""
    sym = np.zeros((k, ps), np.uint8)
    row = 0
    for p, rc in zip(band_out[:6], row_counts):
        raw = p.cpu().numpy().reshape(-1).view(np.uint8)
        sym.reshape(-1)[row * ps: row * ps + raw.size] = raw
        row += rc
    return np.concatenate([sym, band_out[6].cpu().numpy()])


class ShardedReceiverStep:
    """The multi-device receiver step, the mirror of
    :class:`ShardedSenderStep` (ref :289-436).  Per band, on its device:

    1. the LDGM erasure peel over that band's ``[k + m, ps]`` symbols, lost
       rows zeroed (``LdgmSession._decode_device_fn``: K2 once a round);
    2. a band-local host stage: the recovered container sliced into the six
       slot parts (static row ranges), assembled into the band's JPEG stream
       and entropy-decoded by the C scan decoder;
    3. the reverse mega product of the band's coefficients on its device.

    A band whose erasures are beyond the code's reach is decoded from zero
    coefficients and flagged in ``ok`` (the receiver's concealment, ref:
    src/rtp/video_decoders.cpp).  The frame stays per band.
    """

    def __init__(self, width: int, height: int, mesh: Mesh, in_codec: Codec = Codec.UYVY,
                 quality: int = 80, k: int = 32, m: int = 8, c: int = 3,
                 wwords: Optional[int] = None):
        self.mesh = mesh
        self.nshards = mesh.shape["spatial"]
        self.devices = mesh.spatial
        self.band = _band_encoder(width, height, self.nshards, in_codec, quality)
        if wwords is not None:
            self.band.wwords = wwords
        self.k, self.m, self.c = k, m, c
        self.ps, self.row_counts, self.part_words = slot_container_geometry(self.band, k)
        self.session = LdgmSession(k, m, c, seed=1)
        self._peels = {}  # device -> the peel there
        self._dec = JpegDecoder(self.devices[0])
        self.rounds = []  # peel rounds per band of the last call

    # -- band-local host stage -------------------------------------------

    def _band_arrays(self, rows: np.ndarray):
        """Recovered container rows [k, ps] -> the six slot parts."""
        starts = np.concatenate([[0], np.cumsum(self.row_counts)])
        out = []
        for i, w in enumerate(self.part_words):
            arr = np.ascontiguousarray(rows[starts[i]:starts[i + 1]]).reshape(-1)[: w * 4].view(np.uint32)
            out.append(arr.view(np.int32) if i % 2 else arr.reshape(-1, self.band.wwords))
        return out

    def _assemble_band(self, rows: np.ndarray) -> bytes:
        body = self.band.assemble(*self._band_arrays(rows))
        return self.band._header + body.tobytes() + b"\xff\xd9"

    # -- stages ------------------------------------------------------------

    def peel(self, symbols, present) -> List[tuple]:
        """Stage 1: per band (symbols [k + m, ps] uint8, have [k + m] bool)
        after the peel, on the band's device.  ``symbols``: [n, k + m, ps]
        (array or tensor) or one block per band; ``present``: [n, k + m]."""
        present = np.asarray(present.cpu() if isinstance(present, torch.Tensor) else present, bool)
        out, self.rounds = [], []
        for s, dev in enumerate(self.devices):
            blk = symbols[s]
            sym = blk.to(dev) if isinstance(blk, torch.Tensor) else torch.as_tensor(np.asarray(blk), device=dev)
            have = torch.as_tensor(present[s], device=dev)
            run = self._peels.get(dev)
            if run is None:
                run = self._peels[dev] = self.session._decode_device_fn(self.ps, dev)
            sym, have, rounds = run(sym.to(torch.uint8), have)
            out.append((sym, have))
            self.rounds.append(rounds)
        return out

    def host_decode(self, peeled):
        """Stage 2: (hdr, nmcux, nmcuy of a band, per band its [cy, cu, cv]
        int16 coefficients or None, ok)."""
        ok = np.zeros(self.nshards, bool)
        coeffs = [None] * self.nshards
        hdr = nmcux = nmcuy = None
        for s, (sym, have) in enumerate(peeled):
            if not bool(have[: self.k].all()):
                continue
            decoded = entropy_decode_422(self._assemble_band(sym[: self.k].cpu().numpy()))
            if decoded is not None:
                hdr, coeffs[s], nmcux, nmcuy = decoded
                ok[s] = True
        if hdr is None:
            raise ValueError("no band recovered")
        return hdr, nmcux, nmcuy, coeffs, ok

    def device_decode(self, hdr, nmcux: int, nmcuy: int, coeffs) -> List[torch.Tensor]:
        """Stage 3: per band its coefficients (zeros for a lost band) up to
        its device and through the reverse mega product."""
        fn = self._dec._make_mega_uyvy_fn(hdr, nmcux, nmcuy)
        shapes = [o.shape for o in next(c for c in coeffs if c is not None)]
        bands = []
        for c, dev in zip(coeffs, self.devices):
            if c is None:
                c = [np.zeros(shape, np.int16) for shape in shapes]
            bands.append(fn(*(torch.as_tensor(o, device=dev) for o in c)))
        return bands

    def __call__(self, symbols, present):
        """symbols: [n, k + m, ps] uint8 (lost rows arbitrary), or one block
        per band; present: [n, k + m] bool.  Returns (UYVY row bands, each
        on its device, never gathered; ok [n] bool, False for a band that
        could not be recovered)."""
        hdr, nmcux, nmcuy, coeffs, ok = self.host_decode(self.peel(symbols, present))
        return self.device_decode(hdr, nmcux, nmcuy, coeffs), ok
