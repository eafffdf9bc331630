"""Row-sharded JPEG + LDGM: one frame split into row bands over a mesh.

Port of ``ultragrid_tpu/parallel/sharded_jpeg.py``, the analogue of the
reference's tiled-4K/8K mode (ref: src/utils/video.c:67-74, tiles as
independent substreams; src/host.h:98, tiles round-robined over CUDA
devices).  The frame's MCU rows split into one band per device of the
mesh's 'spatial' axis; the restart interval divides the band's MCU count, so
no entropy segment crosses a band and the bands' slots, concatenated, are
bit-identical to a single-device encode of the frame.

Each band runs on its own device, one after the other from this process:
kernel K1 (``JpegEncoder._encode``) once per band, K2 (``Gf2Parity``) once
per band in the sender step, and K2 once per peel round per band in the
receiver step.  Outputs stay per band (lists), as the deployment sends each
band as its own substream: nothing is gathered.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ultragrid_tpu_torch.models.encode import ldgm_container_params
from ultragrid_tpu_torch.ops.fec import Gf2Parity, LdgmSession, build_ldgm_matrix
from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, JpegEncoder, entropy_decode_422
from ultragrid_tpu_torch.parallel.mesh import Mesh, shard_frame_rows
from ultragrid_tpu_torch.types import Codec


def _band_encoder(width: int, height: int, nshards: int, in_codec: Codec, quality: int) -> JpegEncoder:
    """The encoder of one band, its restart interval a divisor of the MCU
    row width so that segments never span bands (ref :43-54)."""
    if height % (8 * nshards):
        raise ValueError("height must split into MCU rows per shard")
    local_h = height // nshards
    probe = JpegEncoder(width, local_h, in_codec=in_codec, quality=quality)
    ri = probe.restart_interval
    while probe.nmcux % ri:
        ri -= 1
    return JpegEncoder(width, local_h, in_codec=in_codec, quality=quality, restart_interval=ri)


class ShardedJpegEncoder:
    """JPEG encode over the 'spatial' axis of a mesh (rows -> devices)."""

    def __init__(self, width: int, height: int, mesh: Mesh, in_codec: Codec = Codec.UYVY,
                 quality: int = 80):
        self.mesh = mesh
        self.nshards = mesh.shape["spatial"]
        self.devices = mesh.spatial
        self.local = _band_encoder(width, height, self.nshards, in_codec, quality)
        # a whole-frame encoder for the header and the assembly
        self.full = JpegEncoder(width, height, in_codec=in_codec, quality=quality,
                                restart_interval=self.local.restart_interval, state=self.local.state)
        self.full.wwords = self.local.wwords

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

    def _escalate(self) -> None:
        """Double the slot width on overflow (as ``JpegEncoder.escalate_and_retry``;
        keeps the band and whole-frame encoders in step)."""
        ww = min(self.local.wwords * 2, 64)
        self.local.wwords = self.full.wwords = ww

    def encode(self, frame) -> np.ndarray:
        """-> the whole frame's JPEG file, byte-equal to a single-device
        ``JpegEncoder`` with the same restart interval."""
        bands = self.shard(frame)
        parts = self.encode_device(bands)
        while self.local.wwords < 64 and any(bool(p[-1]) for p in parts):
            self._escalate()
            parts = self.encode_device(bands)
        host = [np.concatenate([p[i].cpu().numpy() for p in parts]) for i in range(6)]
        body = self.full.assemble(*host)
        return np.concatenate([np.frombuffer(self.full._header, np.uint8), body,
                               np.frombuffer(b"\xff\xd9", np.uint8)])


class ShardedJpegDecoder:
    """Receive-side twin of :class:`ShardedJpegEncoder`: the host C entropy
    decode fills per-MCU coefficient blocks, which split into MCU-row bands
    (one per device), and the reverse mega product
    (``JpegDecoder._make_mega_uyvy_fn``) runs per band on its device (ref
    :127-183).  The bands are bit-identical to the single-device decode's
    rows."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.nshards = mesh.shape["spatial"]
        self.devices = mesh.spatial
        self._single = JpegDecoder(self.devices[0])

    def decode_to_uyvy(self, data: bytes):
        """Returns (UYVY row bands [H / n, 2W] uint8, each on its device, h,
        w); a stream that is not 4:2:2 or whose MCU rows do not split takes
        the single-device decode, one band on the first device; None where
        that gives None."""
        decoded = entropy_decode_422(data)
        if decoded is None or decoded[3] % self.nshards:
            res = self._single.decode_to_uyvy(data)
            return None if res is None else ([res[0]], res[1], res[2])
        hdr, outs, nmcux, nmcuy = decoded
        ns = self.nshards
        fn = self._single._make_mega_uyvy_fn(hdr, nmcux, nmcuy // ns)
        bands = []
        for s, dev in enumerate(self.devices):
            coeffs = [torch.as_tensor(o.reshape(ns, -1, 64)[s], device=dev) for o in outs]
            bands.append(fn(*coeffs))
        return bands, hdr["h"], hdr["w"]


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
    on the band's device.  Every output stays per band: each band is an
    independent RTP substream (ref: tiled substream IDs, src/transmit.c:490),
    packetised from its device's memory.

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
