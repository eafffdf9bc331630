"""Receiver-side audio reassembly (ref: src/rtp/audio_decoders.cpp).

Per-channel reassembly from the 5-word audio payload header; decompress by
wire codec tag; hand to playback.

The port's copy of ``ultragrid_tpu/net/audio_rx.py``.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

from ultragrid_tpu_torch.audio.codecs import get_audio_codec
from ultragrid_tpu_torch.audio.types import TAG_TO_CODEC, AudioDesc, AudioFrame
from ultragrid_tpu_torch.net import rtp_types as rt
from ultragrid_tpu_torch.net.pbuf import PbufNode
from ultragrid_tpu_torch.ops.fec import RsSession
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("audio_rx")

# upper bound on the untrusted data_len header field (a spoofed packet must
# not force a huge allocation; 16 MiB ≫ any real audio buffer)
MAX_AUDIO_FRAME_LEN = 1 << 24


AUDIO_ENCRYPTED_PTS = {
    rt.PT_ENCRYPT_AUDIO: rt.PT_AUDIO,
    rt.PT_ENCRYPT_AUDIO_RS: rt.PT_AUDIO_RS,
}


class AudioRxState:
    """Reassembly and decode of one audio stream.  Encrypted audio (PT 25/36,
    ``-e``) is decrypted with ``decryption`` (a ``utils/crypto.PacketCrypto``);
    without a key its frames are dropped, as in the reference."""

    def __init__(self, decryption=None) -> None:
        self.frames_ok = 0
        self.decryption = decryption

    def _maybe_decrypt(self, node: PbufNode) -> bool:
        """Decrypt PT 25/36 packet payloads in place (ref: the audio leg of
        the per-packet AES scheme, rtp_types.h:75-80); False on a missing
        key or a failed check."""
        plain = AUDIO_ENCRYPTED_PTS.get(node.packets[0].pt)
        if plain is None:
            return True
        if self.decryption is None:
            log.warning("received encrypted audio but no decryption key set")
            return False
        for pkt in node.packets:
            if getattr(pkt, "_decrypted", False):
                continue
            hdr = bytes(pkt.payload[: rt.AUDIO_PAYLOAD_HDR_LEN])  # the payload may be a view
            data = self.decryption.decrypt(bytes(pkt.payload[rt.AUDIO_PAYLOAD_HDR_LEN + 4:]), hdr)
            if data is None:
                return False
            pkt.payload = hdr + data
            pkt.pt = plain
            pkt._decrypted = True
        return True

    def _decode_g711_standard(self, node: PbufNode) -> Optional[AudioFrame]:
        """RFC 3551 static payloads: PT 0 = PCMU, PT 8 = PCMA (8 kHz mono,
        raw G.711 bytes, no UltraGrid audio header)."""
        pkts = sorted(node.packets, key=lambda p: p.seq)
        codec_name = "ulaw" if pkts[0].pt == 0 else "alaw"
        raw = b"".join(bytes(p.payload) for p in pkts)
        if not raw:
            return None
        desc = AudioDesc(bps=1, sample_rate=8000, ch_count=1, codec=codec_name)
        frame = AudioFrame(desc, [np.frombuffer(raw, np.uint8)])
        frame = get_audio_codec(codec_name).decompress(frame)
        self.frames_ok += 1
        return frame

    def decode_frame(self, node: PbufNode) -> Optional[AudioFrame]:
        if not node.packets:
            return None
        if node.packets[0].pt in (0, 8):
            return self._decode_g711_standard(node)
        if not self._maybe_decrypt(node):
            return None
        channels: Dict[int, np.ndarray] = {}
        got: Dict[int, np.ndarray] = {}
        desc = None
        codec_name = "PCM"
        is_rs = False
        fec_params = 0
        for pkt in node.packets:
            if pkt.pt not in (rt.PT_AUDIO, rt.PT_AUDIO_RS) or len(pkt.payload) < rt.AUDIO_PAYLOAD_HDR_LEN:
                continue
            ch, buf_idx, offset, data_len, bps, rate, tag = rt.parse_audio_header(pkt.payload)
            if data_len > MAX_AUDIO_FRAME_LEN or data_len <= 0:
                log.warning(f"bogus audio frame length {data_len}; dropping packet")
                continue
            if pkt.pt == rt.PT_AUDIO_RS:
                is_rs = True
                fec_params = tag
            else:
                codec_name = TAG_TO_CODEC.get(tag, "PCM")
            data = pkt.payload[rt.AUDIO_PAYLOAD_HDR_LEN :]
            if ch not in channels:
                channels[ch] = np.zeros(data_len, np.uint8)
                got[ch] = np.zeros(data_len, bool)
            end = min(offset + len(data), data_len)
            channels[ch][offset:end] = np.frombuffer(data[: end - offset], np.uint8)
            got[ch][offset:end] = True
            desc = AudioDesc(bps=bps, sample_rate=rate, ch_count=len(channels), codec=codec_name)
        if desc is None:
            return None
        if is_rs:
            # recover each channel: [4B tag][channel data] protected by RS
            # (fec params from the tag word: k<<19|m<<6, audio_decoders.cpp:264)
            k = fec_params >> 19
            m = (fec_params >> 6) & 0x1FFF
            rs = RsSession(k, k + m)
            recovered: Dict[int, np.ndarray] = {}
            for ch, buf in channels.items():
                ss = buf.size // (k + m)
                symbols = buf[: (k + m) * ss].reshape(k + m, ss)
                # erasure map: a symbol is present only if every byte of it
                # arrived (ref: audio_decoders.cpp audio_fec_decode passes the
                # received-offset map so RS knows which symbols are erased)
                present = got[ch][: (k + m) * ss].reshape(k + m, ss).all(axis=1)
                payload = rs.decode(symbols, present)
                if payload is None or payload.size < 4:
                    return None
                (tag,) = struct.unpack("<I", payload[:4].tobytes())
                codec_name = TAG_TO_CODEC.get(tag, "PCM")
                recovered[ch] = payload[4:]
            channels = recovered
            desc = desc.with_(codec=codec_name)
        desc = desc.with_(ch_count=max(channels) + 1)
        chans = [channels.get(c, np.zeros(0, np.uint8)) for c in range(desc.ch_count)]
        frame = AudioFrame(desc, chans)
        if codec_name != "PCM":
            try:
                frame = get_audio_codec(codec_name).decompress(frame)
            except ValueError:
                log.warning(f"cannot decode audio codec {codec_name}")
                return None
        self.frames_ok += 1
        return frame
