"""Video and audio packetizer and traffic shaper (ref: src/transmit.c).

The port's copy of ``ultragrid_tpu/net/transmit.py``.  Wire-compatible:
symbol-aligned packet splitting (get_packet_sizes, transmit.c:589-623),
video/FEC payload headers, M bit on the frame's last packet, packet pacing
modes unlimited/auto (75% of frame time)/fixed (get_packet_rate,
transmit.c:653-689), mult:N duplication.

FEC goes through the port's :func:`ultragrid_tpu_torch.ops.fec.fec_from_spec`.
An LDGM tile that is a tensor (the JPEG file that ``JpegCompress`` leaves
on its device, or a frame) has its whole buffer built on its own device
(``LdgmSession.encode_tensor``: one copy and kernel K2 on the card, its
plain version on the CPU) and brought down once into a buffer the Tx
reuses, pinned for the card; an array tile takes the shared host C XOR, as
in the reference.  Every other tile on the card is copied to the host once,
in :meth:`Tx.send_video`, before FEC and packetisation.  Audio
(:meth:`Tx.send_audio`) is per-channel packets with the 5-word audio header,
optionally Reed-Solomon protected with the parity product on the Tx's
device.  Standards mode (``Tx(rfc2435=True)``) sends a JPEG frame as RFC 2435
fragments on PT 26 (``net/rtpdec_jpeg.py``), one unpaced ``send_data_hdr``
per packet; :meth:`Tx.send_audio_standard` is the reference's G.711 API (PT
0 at 8 kHz), which its sender never calls either.  ``encryption`` (a
``utils/crypto.PacketCrypto``, ``-e``) encrypts each packet's payload with
its payload header as the AAD, appends the crypto word to the header and
sends the encrypted payload types (ref: transmit.c:789-802); video still
goes out through the C batch sender.
"""

from __future__ import annotations

import struct
from fractions import Fraction
from typing import List, Optional

import numpy as np
import torch

from ultragrid_tpu_torch.audio.codecs import get_audio_codec
from ultragrid_tpu_torch.audio.resampler import resample_channel
from ultragrid_tpu_torch.audio.types import AUDIO_TAGS, AudioFrame
from ultragrid_tpu_torch.device import get_device, host_bytes
from ultragrid_tpu_torch.net import rtp_types as rt
from ultragrid_tpu_torch.net.rtp import RtpSession, get_local_mediatime
from ultragrid_tpu_torch.net.rtpdec_jpeg import packetize as rfc2435_packetize
from ultragrid_tpu_torch.ops.fec import FecDesc, LdgmSession, RsSession, fec_from_spec
from ultragrid_tpu_torch.types import (
    PIX_BLOCK_LCM,
    Codec,
    VideoFrame,
    get_codec_info,
    is_codec_opaque,
    vc_get_linesize,
)
from ultragrid_tpu_torch.utils import profiler
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("transmit")

RATE_UNLIMITED = -1
RATE_AUTO = 0
RATE_DYNAMIC = -2  # auto, but an occasional huge frame may exceed frame time
_EXCESS_GAP = 4  # min frames between excess frames (ref: transmit.c:130)


def parse_bitrate(spec: str):
    """Parse the ``-l/--limit-bitrate`` grammar (ref: parse_bitrate,
    rtp_common.c:777-840): ``auto | dynamic | unlimited | <num>[kMG][!][E]``.
    Returns (bitrate, fixed): bitrate is bps or a RATE_* sentinel; fixed
    means send at the nominal rate even when auto would be slower ('E')."""
    spec = (spec or "").strip()
    named = {"auto": RATE_AUTO, "dynamic": RATE_DYNAMIC,
             "unlimited": RATE_UNLIMITED, "": RATE_AUTO}
    if spec in named:
        return named[spec], False
    fixed = False
    while spec and spec[-1] in "!E":
        if spec[-1] == "E":
            fixed = True
        spec = spec[:-1]  # '!' just acknowledges an intentionally low rate
    mult = 1
    if spec and spec[-1] in "kKMG":
        mult = {"k": 1_000, "K": 1_000, "M": 1_000_000, "G": 1_000_000_000}[spec[-1]]
        spec = spec[:-1]
    try:
        bps = int(float(spec) * mult)
    except ValueError:
        raise ValueError(f"bad bitrate spec {spec!r}") from None
    if bps <= 0:
        raise ValueError("bitrate must be positive")
    return bps, fixed


IPV4_HDR_LEN = 20
UDP_HDR_LEN = 8


def get_video_pkt_len(mtu: int, symbol_size: int, symbol_offset: int):
    """ref: get_video_pkt_len, transmit.c:573-586."""
    if symbol_size > mtu:
        if symbol_size - symbol_offset <= mtu:
            return symbol_size - symbol_offset, 0
        return mtu, symbol_offset + mtu
    return mtu // symbol_size * symbol_size, symbol_offset


def get_packet_sizes(
    data_len: int, codec: Codec, width: int, fec: Optional[FecDesc], mtu: int
) -> List[int]:
    """ref: get_packet_sizes, transmit.c:589-623 (mtu = netto payload len)."""
    symbol_size = 1
    symbol_offset = 0
    if fec is None and not is_codec_opaque(codec):
        symbol_size = vc_get_linesize(width, codec)
        info = get_codec_info(codec)
        pf_block = PIX_BLOCK_LCM // info.block_size_pixels * info.block_size_bytes
        assert pf_block <= mtu
        mtu = mtu // pf_block * pf_block
    elif fec is not None:
        symbol_size = fec.symbol_size
    sizes: List[int] = []
    pos = 0
    while True:
        if symbol_size == 1:
            length = mtu
        else:
            length, symbol_offset = get_video_pkt_len(mtu, symbol_size, symbol_offset)
        pos += length
        sizes.append(length)
        if pos >= data_len:
            break
    if pos > data_len:
        sizes[-1] -= pos - data_len
    return sizes


class Tx:
    """Sender packetizer state (ref: struct tx + tx_init, transmit.c).

    ``device`` is where the RS parity product runs, for video and audio (the
    card unless the caller names another; it raises without one).  An LDGM
    tile that is a tensor has its buffer built on its own device, an array
    tile by the host C encoder; ``fec_routes`` counts the frames' tiles by
    where their buffer was built ("card" or "host")."""

    def __init__(
        self,
        mtu: int = 1500,
        fec_spec: str = "none",
        bitrate: int = RATE_AUTO,
        mult_count: int = 1,
        bitrate_fixed: bool = False,
        encryption=None,
        rfc2435: bool = False,
        device="cuda",
    ):
        self.mtu = mtu
        self.encryption = encryption
        self.bitrate = bitrate
        self.bitrate_fixed = bitrate_fixed
        self.device = get_device(device)
        self._dyn_avg_frame = 0.0  # RATE_DYNAMIC state (ref: transmit.c:672-680)
        self._dyn_last_excess = _EXCESS_GAP + 1
        self.mult_count = mult_count
        self.buffer = 0  # 22-bit buffer id
        if fec_spec.startswith("mult:"):
            self.mult_count = int(fec_spec.split(":")[1])
            fec_spec = "none"
        self.fec_spec = fec_spec
        self._fec = None
        self._last_audio_ts = -1
        # standards mode: JPEG frames go out as RFC 2435 / PT 26 instead of
        # the UltraGrid payload header (interop with ffmpeg/GStreamer/RTSP)
        self.rfc2435 = rfc2435
        self.fec_routes = {"card": 0, "host": 0}
        self._pinned: Optional[torch.Tensor] = None  # the card's LDGM buffers come down here

    def _get_fec(self, frame_size: int):
        if self.fec_spec in ("", "none"):
            return None
        if self._fec is None:
            self._fec = fec_from_spec(self.fec_spec, frame_size, self.mtu)
        return self._fec

    def send_video(self, session: RtpSession, frame: VideoFrame) -> int:
        """FEC-encode (optionally) + packetize + send one frame.

        Multi-tile frames send each tile as its own RTP substream with the
        same timestamp; only the very last packet carries the M bit
        (ref: tx_send, transmit.c:440-478).  Each tile, or the LDGM buffer of
        a tensor tile, comes to the host once, here.
        """
        ts = get_local_mediatime() if frame.timestamp < 0 else rt.video_rtp_ts(frame.timestamp)
        if self.rfc2435 and frame.desc.color_spec == Codec.JPEG:
            return self._send_rfc2435(session, frame, ts)
        sent = 0
        for ti, tile in enumerate(frame.tiles):
            sent += self._send_tile(session, frame, tile, ts, substream=ti,
                                    send_m=(ti == len(frame.tiles) - 1))
        self.buffer = (self.buffer + 1) & 0x3FFFFF
        return sent

    def _send_rfc2435(self, session: RtpSession, frame: VideoFrame, ts: int) -> int:
        """Send one JPEG frame as RFC 2435 fragments (PT 26)."""
        jpeg = host_bytes(frame.tiles[0]).tobytes()
        payloads = rfc2435_packetize(jpeg, mtu_payload=self.mtu - 40)
        for i, p in enumerate(payloads):
            session.send_data_hdr(ts, rt.PT_JPEG, i == len(payloads) - 1, b"", p)
        self.buffer = (self.buffer + 1) & 0x3FFFFF
        return len(payloads)

    def _send_tile(self, session: RtpSession, frame: VideoFrame, tile, ts: int,
                   substream: int, send_m: bool) -> int:
        """ref: tx_send_base, transmit.c:698-827."""
        desc = frame.desc
        size = tile.numel() if isinstance(tile, torch.Tensor) else np.asarray(tile).size
        fec = self._get_fec(size)
        fec_desc = None
        if fec is not None:
            # the reference prepends the video payload header to the protected
            # payload (encode_hdr_frame, ldgm.cpp:455-460)
            video_hdr = rt.pack_video_header(desc, self.buffer, 0, size, substream)
            with profiler.zone("tx.fec"):
                if isinstance(fec, RsSession):
                    data, fec_desc = fec.encode(host_bytes(tile), hdr=video_hdr, device=self.device)
                elif isinstance(tile, torch.Tensor):
                    data, fec_desc = self._ldgm_on_tile_device(fec, tile, video_hdr)
                else:
                    data, fec_desc = fec.encode(np.concatenate([np.frombuffer(video_hdr, np.uint8),
                                                                host_bytes(tile)]))
                    self.fec_routes["host"] += 1
        else:
            data = host_bytes(tile)

        enc = self.encryption is not None
        netto = self.mtu - (IPV4_HDR_LEN + UDP_HDR_LEN + rt.RTP_HDR_LEN)
        if fec_desc is not None:
            netto -= rt.FEC_PAYLOAD_HDR_LEN
            pt = rt.fec_pt(fec_desc.type, enc)
        else:
            netto -= rt.VIDEO_PAYLOAD_HDR_LEN
            pt = rt.fec_pt("none", enc) if enc else rt.PT_VIDEO
        if enc:
            # crypto hdr word + fixed overhead (len+IV+tag/crc)
            netto -= 4 + 36 + 15

        sizes = get_packet_sizes(data.size, desc.color_spec, desc.width, fec_desc, netto)
        npkt = len(sizes) * self.mult_count
        packet_rate = self._packet_rate(desc.fps, npkt, data.size)

        # vectorized headers + the C sendmmsg batch sender (csrc/udp_tx.c,
        # the reference's native transmit loop role)
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        szs = np.asarray(sizes, np.int32)
        if fec_desc is not None:
            proto = rt.pack_fec_header(
                self.buffer, 0, data.size,
                fec_desc.k, fec_desc.m, fec_desc.c, fec_desc.seed, substream,
            )
        else:
            proto = rt.pack_video_header(desc, self.buffer, 0, data.size, substream)
        hdrs = np.tile(np.frombuffer(proto, np.uint8), (len(sizes), 1))
        # word 1 (bytes 4..8) is the per-packet frame offset, big-endian
        hdrs[:, 4:8] = offsets.astype(">u4").view(np.uint8).reshape(-1, 4)
        if enc:
            hdrs, data, offsets, szs = self._encrypted(hdrs, data, offsets, szs)
        total = 0
        with profiler.zone("tx.pace"):  # the paced batch send: 75% of the frame period at RATE_AUTO
            for m_iter in range(self.mult_count):
                last_round = m_iter == self.mult_count - 1
                total += session.send_batch(
                    ts, pt, hdrs, data, offsets, szs,
                    m_last=send_m and last_round,
                    pace_ns=int(packet_rate * 1e9),
                )
        return total

    def _ldgm_on_tile_device(self, fec: LdgmSession, tile: torch.Tensor, video_hdr: bytes):
        """The LDGM buffer of ``video_hdr`` ++ ``tile`` built on the tile's
        device, after its writer on the pipeline's stream, and brought down
        once into the buffer this Tx reuses (the send of the frame before
        is over; pinned for the card), waited for by an event.  (host array
        view, FecDesc)."""
        buf, fec_desc = fec.encode_tensor(tile, hdr=video_hdr)
        host = self._pinned
        if host is None or host.numel() < buf.numel():
            grown = buf.numel() if host is None else max(buf.numel(), host.numel() * 3 // 2)
            host = self._pinned = torch.empty(grown, dtype=torch.uint8, pin_memory=buf.is_cuda)
        host = host[: buf.numel()]
        host.copy_(buf, non_blocking=True)
        if buf.is_cuda:
            torch.cuda.current_stream(buf.device).record_event().synchronize()
        self.fec_routes["card" if buf.is_cuda else "host"] += 1
        return host.numpy(), fec_desc

    def _encrypted(self, hdrs: np.ndarray, data: np.ndarray, offsets: np.ndarray, sizes: np.ndarray):
        """A batch with each packet's payload encrypted, its payload header
        the AAD, and the crypto word appended to each header: (headers,
        payload, offsets, sizes)."""
        crypto = self.encryption
        payloads = [crypto.encrypt(data[o: o + n].tobytes(), h.tobytes()) for h, o, n in zip(hdrs, offsets, sizes)]
        lens = np.array([len(p) for p in payloads], np.int32)
        word = np.frombuffer(crypto.crypto_header(), np.uint8)
        return (np.concatenate([hdrs, np.broadcast_to(word, (len(hdrs), word.size))], axis=1),
                np.frombuffer(b"".join(payloads), np.uint8),
                np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64), lens)

    def send_audio_standard(self, session: RtpSession, frame) -> int:
        """Standards-mode G.711 audio: the RFC 3551 static payload PT 0
        (PCMU; as in the reference, PCMA's PT 8 is only received), 8 kHz
        mono/stereo interleaved, 20 ms per packet — interoperable with any
        SIP/RTSP receiver (the UltraGrid-native path uses the 5-word audio
        header instead).  Host numpy, as the reference's."""
        desc = frame.desc
        if desc.sample_rate != 8000:
            # G.711 static payloads are defined at 8 kHz (RFC 3551 table 4)
            fr = Fraction(8000, desc.sample_rate)
            chans = []
            for ch in frame.channels:
                x = np.asarray(ch, np.uint8).view("<i2").astype(np.float64)
                y = resample_channel(x, fr.numerator, fr.denominator)
                chans.append(np.frombuffer(np.clip(y, -32768, 32767).astype("<i2").tobytes(), np.uint8))
            nf = AudioFrame(desc.with_(sample_rate=8000, bps=2), chans)
            nf.timestamp = frame.timestamp
            frame = nf
            desc = frame.desc
        comp = get_audio_codec("ulaw").compress(frame)
        pt = 0  # PCMU
        data = np.asarray(comp.channels[0], np.uint8)
        if desc.ch_count == 2:
            # RFC 3551: stereo is sample-interleaved
            r = np.asarray(comp.channels[1], np.uint8)
            inter = np.empty(data.size + r.size, np.uint8)
            inter[0::2] = data
            inter[1::2] = r
            data = inter
        step = 160 * desc.ch_count  # 20 ms at 8 kHz
        ts = int(frame.timestamp * 8000) & 0xFFFFFFFF if frame.timestamp >= 0 else 0
        sent = 0
        for off in range(0, data.size, step):
            chunk = data[off : off + step].tobytes()
            session.send_data_hdr(ts + off // desc.ch_count, pt, False, b"", chunk)
            sent += 1
        return sent

    def send_audio(self, session: RtpSession, frame, codec_name: str = "PCM",
                   fec_spec: str = "none") -> int:
        """Per-channel audio packetization (ref: audio_tx_send_chan,
        transmit.c:829+): each channel's data split into MTU chunks with the
        5-word audio payload header; M bit on the frame's last packet.

        With ``fec_spec="rs:k:n"`` each channel is Reed-Solomon protected
        (PT_AUDIO_RS; fec params ride in the header's codec-tag word, the tag
        itself travels inside the protected payload — ref: audio_fec_decode,
        audio_decoders.cpp:260-271); the parity product runs on the Tx's
        device."""
        ts = get_local_mediatime()
        # packetized codecs may emit several buffers per audio cycle
        # back-to-back (compress_multi); the playout buffer keys frames by
        # RTP TS, so a 90 kHz tick collision would merge two codec packets
        # into one buffer — keep audio TS strictly increasing
        if ts <= self._last_audio_ts:
            ts = (self._last_audio_ts + 1) & 0xFFFFFFFF
        self._last_audio_ts = ts
        tag = AUDIO_TAGS.get(codec_name, 0x0001)
        pt = rt.PT_AUDIO
        rs = None
        if fec_spec.startswith("rs"):
            if self._fec is None or self.fec_spec != fec_spec:
                self._fec = fec_from_spec(fec_spec)
                self.fec_spec = fec_spec
            rs = self._fec
            pt = rt.PT_AUDIO_RS
        enc = self.encryption is not None
        if enc:
            # per-packet AES like video (ref: PT_ENCRYPT_AUDIO[_RS],
            # rtp_types.h:75-80, and the transmit.c:789-802 encrypt hook)
            pt = rt.PT_ENCRYPT_AUDIO_RS if rs is not None else rt.PT_ENCRYPT_AUDIO
        netto = self.mtu - (IPV4_HDR_LEN + UDP_HDR_LEN + rt.RTP_HDR_LEN + rt.AUDIO_PAYLOAD_HDR_LEN)
        if enc:
            netto -= 4 + 36 + 15  # crypto hdr word + len+IV+tag/crc overhead
        sent = 0
        nch = len(frame.channels)
        for ch, data in enumerate(frame.channels):
            data = np.asarray(data, np.uint8)
            if rs is not None:
                buf, fdesc = rs.encode(data, hdr=struct.pack("<I", tag), device=self.device)
                data = buf
                tag_word = (fdesc.k << 19) | (fdesc.m << 6)
            else:
                tag_word = tag
            pos = 0
            n = data.size
            while pos < n or (n == 0 and pos == 0):
                chunk = data[pos : pos + netto]
                hdr = rt.pack_audio_header(
                    ch, self.buffer, pos, n,
                    frame.desc.bps, frame.desc.sample_rate, tag_word,
                )
                # M only on the whole frame's (= last channel's) final packet,
                # else the playout buffer decodes before all channels arrive
                last = ch == nch - 1 and pos + chunk.size >= n
                payload = chunk.tobytes()
                if enc:
                    payload = self.encryption.encrypt(payload, hdr)
                    hdr = hdr + self.encryption.crypto_header()
                session.send_data_hdr(ts, pt, last, hdr, payload)
                pos += max(chunk.size, 1)
                sent += 1
        self.buffer = (self.buffer + 1) & 0x3FFFFF
        return sent

    def _packet_rate(self, fps: float, packet_count: int, data_len: int) -> float:
        """Inter-packet interval in seconds (ref: get_packet_rate,
        transmit.c:653-689)."""
        if self.bitrate == RATE_UNLIMITED:
            return 0.0
        time_for_frame = 1.0 / max(fps, 1e-6)
        interval = time_for_frame / max(packet_count, 1) * 0.75
        interval = min(interval, self.mtu / 1e6)  # >= 1 Mbps floor
        if self.bitrate == RATE_AUTO:
            return interval
        if self.bitrate == RATE_DYNAMIC:
            # like auto, but an occasional oversized frame (>2x running
            # average) may double its packet rate (ref: transmit.c:671-680)
            if (data_len > 2 * self._dyn_avg_frame
                    and self._dyn_last_excess > _EXCESS_GAP):
                interval /= 2
                self._dyn_last_excess = 0
            else:
                self._dyn_last_excess += 1
            self._dyn_avg_frame = (9 * self._dyn_avg_frame + data_len) / 10
            return interval
        avg_pkt = data_len / max(packet_count, 1)
        fixed = avg_pkt * 8 / self.bitrate
        if self.bitrate_fixed:
            return fixed  # nominal rate even when auto would be slower
        return max(fixed, interval)
