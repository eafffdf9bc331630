"""Receiver-side frame reassembly + FEC recovery.

The port's copy of ``ultragrid_tpu/net/video_rx.py``.  Analogue of the
reference's decode_video_frame (src/rtp/video_decoders.cpp:1528-1843):
reassemble packets into the frame buffer by payload-header offsets, zero-fill
holes, run LDGM/RS recovery for FEC payload types.  Reassembly is host work
into host buffers; ``--param ldgm-device=device`` sends the LDGM peel to the
port's :meth:`LdgmSession.decode_device` (kernel K2 on the card).  A
display-owned framebuffer on the card is filled by one upload per frame.
The standards payloads bypass the C fast depacketizer and are reassembled
here in Python, packet by packet: RFC 2435 (PT 26) into a JFIF file
(``Codec.JPEG``, decoded on the card by the receiver's ``JpegDecompress``)
and RFC 6184 (PT 96) into an Annex-B access unit (``Codec.H264``).
Encrypted payloads (``-e``: PT 24, 29 and 30) are decrypted
in place with ``decryption`` (a ``utils/crypto.PacketCrypto``) before the
reassembly; without a key, or where a packet fails its check, the frame is
dropped, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.net import rtp_types as rt
from ultragrid_tpu_torch.net.pbuf import PbufNode
from ultragrid_tpu_torch.net.rtpdec_h264 import H264Depacketizer
from ultragrid_tpu_torch.net.rtpdec_jpeg import JpegDepacketizer
from ultragrid_tpu_torch.ops.fec import LdgmSession, RsSession
from ultragrid_tpu_torch.ops.jpeg import _parse_headers
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, codec_is_planar, is_codec_opaque
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.params import add_to_param, get_commandline_param

add_to_param("ldgm-device",
             "* ldgm-device={host|device}\n"
             "  where to run the LDGM erasure solve (default host)")


def _ldgm_on_device() -> bool:
    """--param ldgm-device={host|device}; host is the default (the device
    path pays a host->device round trip that only wins on wide erasures)."""
    return (get_commandline_param("ldgm-device") or "host") == "device"


def host_view(tile) -> Optional[np.ndarray]:
    """A writable flat uint8 numpy view of a tile's own memory (an array or
    a CPU tensor), or None for a tile on the card."""
    if isinstance(tile, torch.Tensor):
        if tile.device.type != "cpu" or tile.dtype != torch.uint8 or not tile.is_contiguous():
            return None
        return tile.numpy().reshape(-1)
    if (not isinstance(tile, np.ndarray) or tile.dtype != np.uint8
            or not tile.flags.c_contiguous or not tile.flags.writeable):
        return None
    return tile.reshape(-1)


def tile_nbytes(tile) -> int:
    return tile.numel() if isinstance(tile, torch.Tensor) else np.asarray(tile).size


def fill_tile(tile: torch.Tensor, buf: np.ndarray) -> None:
    """Copy host bytes into the start of a tile on the card: the frame's one
    upload."""
    tile.view(-1)[: buf.size].copy_(torch.from_numpy(np.ascontiguousarray(buf)))

log = Logger("video_rx")

# Upper bound on the untrusted frame_len payload-header field: a spoofed
# packet must not drive a multi-GiB allocation.  256 MiB covers 8K RG48
# (7680*4320*6 ≈ 199 MB), the largest raw frame any supported mode produces
# (the reference likewise validates buffer lengths before allocating).
MAX_FRAME_LEN = 1 << 28


ENCRYPTED_PTS = {
    rt.PT_ENCRYPT_VIDEO: rt.PT_VIDEO,
    rt.PT_ENCRYPT_VIDEO_LDGM: rt.PT_VIDEO_LDGM,
    rt.PT_ENCRYPT_VIDEO_RS: rt.PT_VIDEO_RS,
}


class FecJob:
    """Reassembled-but-undecoded FEC frame: the rx thread only copies
    packet payloads; the actual LDGM/RS solve runs on the fec thread
    (ref: fec_thread, video_decoders.cpp:423)."""

    __slots__ = ("kind", "buf", "got", "params", "ssrc", "rtp_ts")

    def __init__(self, kind, buf, got, params, ssrc=0, rtp_ts=-1):
        self.kind = kind
        self.buf = buf
        self.got = got
        self.params = params
        self.ssrc = ssrc
        self.rtp_ts = rtp_ts


class VideoRxState:
    """``device``: where ``--param ldgm-device=device`` runs the peel (the
    card unless the caller names another); ``decryption``: the session's
    ``PacketCrypto`` under ``-e``."""

    def __init__(self, device="cuda", decryption=None) -> None:
        self._fec_cache: Dict[Tuple, object] = {}
        self.device = device
        self.decryption = decryption
        self.frames_ok = 0
        self.frames_missing_data = 0
        self.fec_jobs = 0
        self.fec_recovered = 0  # FEC jobs with lost symbols whose frame came back
        # optional display-owned framebuffer provider: desc -> VideoFrame
        # whose buffer the reassembly writes into (the reference's
        # LINE_DECODER path, video_decoders.cpp:1707-1796)
        self.framebuffer_provider = None
        self._h264_dep = None

    def _get_fec(self, kind: str, k: int, m: int, c: int, seed: int):
        key = (kind, k, m, c, seed)
        sess = self._fec_cache.get(key)
        if sess is None:
            if kind == "ldgm":
                sess = LdgmSession(k, m, c, seed)
            else:
                sess = RsSession(k, k + m)
            self._fec_cache[key] = sess
        return sess

    def _maybe_decrypt(self, node: PbufNode) -> Optional[int]:
        """Decrypt packet payloads in place; returns the effective (plain)
        payload type, or None on a failed check or a missing key."""
        pt = node.packets[0].pt
        plain = ENCRYPTED_PTS.get(pt)
        if plain is None:
            return pt
        if self.decryption is None:
            log.warning("received encrypted stream but no decryption key set")
            return None
        hdr_len = (rt.FEC_PAYLOAD_HDR_LEN if plain in (rt.PT_VIDEO_LDGM, rt.PT_VIDEO_RS)
                   else rt.VIDEO_PAYLOAD_HDR_LEN)
        for pkt in node.packets:
            if getattr(pkt, "_decrypted", False):
                continue
            hdr = bytes(pkt.payload[:hdr_len])  # the payload may be a memoryview
            data = self.decryption.decrypt(bytes(pkt.payload[hdr_len + 4:]), hdr)  # past the crypto word
            if data is None:
                return None
            pkt.payload = hdr + data
            pkt._decrypted = True
        return plain

    def decode_frame(self, node: PbufNode) -> Optional[VideoFrame]:
        """Reassemble one pbuf node into a VideoFrame (compressed or raw).
        Single-stage convenience: reassemble + any FEC solve inline."""
        out = self.reassemble(node)
        if out is None:
            return None
        if isinstance(out, FecJob):
            return self.decode_fec_job(out)
        return out

    def reassemble(self, node: PbufNode):
        """Stage-1 work only (the rx thread's share of decode_video_frame,
        video_decoders.cpp:1528-1843): copy packet payloads into the frame
        buffer.  Returns a VideoFrame, a FecJob for the fec thread, or
        None."""
        if not node.packets:
            return None
        pt = self._maybe_decrypt(node)
        if pt is None:
            return None
        if pt == rt.PT_VIDEO:
            frame = self._decode_plain(node)
        elif pt == rt.PT_JPEG:
            # standards-mode RFC 2435 JPEG (no UltraGrid payload header;
            # ref: rtpdec_jpeg.c via the RTSP decode path)
            frame = self._decode_rfc2435(node)
        elif pt == rt.PT_H264:
            # standards-mode RFC 6184 (dynamic PT 96; ref: rtpdec_h264.c)
            frame = self._decode_rfc6184(node)
        elif pt in (rt.PT_VIDEO_LDGM, rt.PT_VIDEO_RS):
            job = self._reassemble_fec(node, "ldgm" if pt == rt.PT_VIDEO_LDGM else "rs")
            if job is not None:
                job.ssrc = node.packets[0].ssrc
                job.rtp_ts = node.ts
            return job
        else:
            log.warning(f"unsupported payload type {pt}")
            return None
        if frame is not None:
            frame.callbacks["ssrc"] = node.packets[0].ssrc
            # RTP TS (90 kHz) = the sender's capture instant; kept in
            # seconds so capture->display latency is measurable downstream
            frame.timestamp = (node.ts & 0xFFFFFFFF) / 90000.0
        return frame

    def _decode_rfc2435(self, node: PbufNode) -> Optional[VideoFrame]:
        """PT 26: reassemble RFC 2435 fragments into a JPEG frame whose data
        is the full JFIF file (color_spec=JPEG); the decompress stage takes
        it from there."""
        dep = JpegDepacketizer()
        jpeg = None
        pkts = sorted(node.packets, key=lambda p: p.seq)
        for i, pkt in enumerate(pkts):
            jpeg = dep.feed(bytes(pkt.payload), marker=bool(pkt.m) or i == len(pkts) - 1)
            if jpeg is not None:
                break
        if jpeg is None:
            self.frames_missing_data += 1
            return None
        self.frames_ok += 1
        hdr = _parse_headers(jpeg)
        desc = VideoDesc(hdr["w"], hdr["h"], Codec.JPEG, 0.0)
        return self._wrap(np.frombuffer(jpeg, np.uint8), desc)

    def _decode_rfc6184(self, node: PbufNode) -> Optional[VideoFrame]:
        """PT 96: reassemble an H.264 access unit (Annex-B) per RFC 6184.
        The frame carries the Annex-B bytes (color_spec=H264); the
        receiver's own H.264 decoder takes it from there."""
        dep = self._h264_dep
        if dep is None:
            dep = self._h264_dep = H264Depacketizer()
        au = None
        pkts = sorted(node.packets, key=lambda p: p.seq)
        for i, pkt in enumerate(pkts):
            au = dep.feed(bytes(pkt.payload), marker=bool(pkt.m) or i == len(pkts) - 1)
        if au is None:
            self.frames_missing_data += 1
            return None
        self.frames_ok += 1
        desc = VideoDesc(dep.width or 1920, dep.height or 1080, Codec.H264, 0.0)
        frame = self._wrap(np.frombuffer(au, np.uint8), desc)
        frame.callbacks["frame_type"] = dep.frame_type
        return frame

    def _decode_plain(self, node: PbufNode) -> Optional[VideoFrame]:
        # per-substream reassembly (multi-tile frames arrive as several
        # substreams with the same RTP TS; ref: tile_idx in the payload
        # header word 0, transmit.c:490)
        bufs: Dict[int, np.ndarray] = {}
        descs: Dict[int, VideoDesc] = {}
        fb_frame = None  # display-owned frame (LINE_DECODER path)
        received = 0
        total = 0
        for pkt in node.packets:
            if len(pkt.payload) < rt.VIDEO_PAYLOAD_HDR_LEN:
                continue
            substream, buffer_idx, offset, frame_len, desc = rt.parse_video_header(
                pkt.payload
            )
            if frame_len > MAX_FRAME_LEN or frame_len <= 0:
                log.warning(f"bogus frame length {frame_len}; dropping packet")
                continue
            data = pkt.payload[rt.VIDEO_PAYLOAD_HDR_LEN :]
            if substream not in bufs:
                buf = None
                if (substream == 0 and not bufs
                        and self.framebuffer_provider is not None):
                    # uncompressed single-substream stream: write packet
                    # payloads STRAIGHT into the display's framebuffer —
                    # zero intermediate copies (ref: LINE_DECODER via
                    # vc_copyline into display_get_frame() buffers,
                    # video_decoders.cpp:1707-1796)
                    # On the card the framebuffer cannot take packets
                    # directly: the frame is reassembled on the host and
                    # uploaded once, below (holes are then zero-filled, as
                    # on the buffered path).
                    fb_frame = self.framebuffer_provider(desc)
                    if fb_frame is not None:
                        if tile_nbytes(fb_frame.tiles[0]) >= frame_len:
                            buf = host_view(fb_frame.tiles[0])
                        else:
                            fb_frame = None
                if buf is None:
                    buf = np.zeros(frame_len, dtype=np.uint8)
                bufs[substream] = buf
                descs[substream] = desc
                total += frame_len
            end = min(offset + len(data), frame_len)
            bufs[substream][offset:end] = np.frombuffer(data[: end - offset], np.uint8)
            received += end - offset
        if not bufs:
            return None
        if received < total:
            self.frames_missing_data += 1
            # the reference zero-fills and passes incomplete frames on
            # (video_decoders.cpp:1828-1843); we do the same
        self.frames_ok += 1
        if len(bufs) == 1:
            (buf,) = bufs.values()
            (desc,) = descs.values()
            if fb_frame is not None:
                if host_view(fb_frame.tiles[0]) is None:
                    fill_tile(fb_frame.tiles[0], buf)
                fb_frame.callbacks["display_owned"] = True
                return fb_frame
            return self._wrap(buf, desc)
        # multi-tile: wrap each substream as a tile
        desc0 = descs[min(descs)]
        frame = self._wrap(bufs[min(bufs)], desc0)
        tiles = []
        for idx in sorted(bufs):
            tiles.append(self._wrap(bufs[idx], descs[idx]).data)
        out = VideoFrame(desc0.with_(tile_count=len(tiles)), tiles)
        return out

    def _reassemble_fec(self, node: PbufNode, kind: str) -> Optional[FecJob]:
        frame_len = 0
        params = None
        buf = None
        got = None
        for pkt in node.packets:
            if len(pkt.payload) < rt.FEC_PAYLOAD_HDR_LEN:
                continue
            substream, buffer_idx, offset, frame_len, k, m, c, seed = rt.parse_fec_header(
                pkt.payload
            )
            if frame_len > MAX_FRAME_LEN or frame_len <= 0:
                log.warning(f"bogus FEC frame length {frame_len}; dropping packet")
                continue
            params = (k, m, c, seed)
            data = pkt.payload[rt.FEC_PAYLOAD_HDR_LEN :]
            if buf is None:
                buf = np.zeros(frame_len, dtype=np.uint8)
                got = np.zeros(frame_len, dtype=bool)
            end = min(offset + len(data), frame_len)
            buf[offset:end] = np.frombuffer(data[: end - offset], np.uint8)
            got[offset:end] = True
        if buf is None or params is None:
            return None
        return FecJob(kind, buf, got, (frame_len, *params))

    def decode_fec_job(self, job: FecJob) -> Optional[VideoFrame]:
        """Stage-2 work: the actual LDGM/RS erasure solve
        (ref: fec::decode in fec_thread, video_decoders.cpp:450)."""
        frame_len, k, m, c, seed = job.params
        sess = self._get_fec(job.kind, k, m, c, seed)
        ss = frame_len // (k + m)
        symbols = job.buf[: (k + m) * ss].reshape(k + m, ss)
        present = job.got[: (k + m) * ss].reshape(k + m, ss).all(axis=1)
        # --param ldgm-device=device routes the erasure solve through the
        # accelerator (iterative XOR-matmul peel; bit-identical), mirroring
        # the reference's ldgm-device={CPU|GPU} switch (src/rtp/ldgm.cpp:211)
        self.fec_jobs += 1
        lost = not bool(present.all())
        if job.kind == "ldgm" and lost and _ldgm_on_device():
            payload = sess.decode_device(symbols, present, device=self.device)
        else:
            payload = sess.decode(symbols, present)
        if payload is None:
            self.frames_missing_data += 1
            return None
        self.fec_recovered += lost
        # payload = [24B video payload header][frame data]
        if payload.size < rt.VIDEO_PAYLOAD_HDR_LEN:
            return None
        _, _, _, inner_len, desc = rt.parse_video_header(payload[: rt.VIDEO_PAYLOAD_HDR_LEN].tobytes())
        frame_data = payload[rt.VIDEO_PAYLOAD_HDR_LEN : rt.VIDEO_PAYLOAD_HDR_LEN + inner_len]
        self.frames_ok += 1
        frame = self._wrap(frame_data, desc)
        frame.callbacks["ssrc"] = job.ssrc
        if job.rtp_ts >= 0:
            frame.timestamp = (job.rtp_ts & 0xFFFFFFFF) / 90000.0
        return frame

    @staticmethod
    def _wrap(buf: np.ndarray, desc: VideoDesc) -> VideoFrame:
        if is_codec_opaque(desc.color_spec) or codec_is_planar(desc.color_spec):
            frame = VideoFrame(desc, [buf])
        else:
            ls = desc.linesize()
            h = desc.height
            if buf.size < h * ls:
                buf = np.pad(buf, (0, h * ls - buf.size))
            frame = VideoFrame(desc, [buf[: h * ls].reshape(h, ls)])
        return frame
