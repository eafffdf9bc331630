"""Audio codecs: PCM passthrough + G.711 A-law/u-law (exact ITU tables).

The port's copy of ``ultragrid_tpu/audio/codecs.py`` (ref: src/audio/codec.{h,c}),
with the libavcodec-backed codecs of ``audio/lavc_codecs.py`` (Opus, G.722,
Speex, MP3, AAC, FLAC) registered beside PCM, A-law and mu-law where
libavcodec's shim loads (ref ``lavc_codecs.py:247-254``); where it does not,
their names are not registered, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Type

import numpy as np

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame


class AudioCodec:
    NAME = "none"

    def compress(self, frame: AudioFrame) -> AudioFrame:
        raise NotImplementedError

    def compress_multi(self, frame: AudioFrame) -> list:
        """One AudioFrame per codec packet, the reference's compress-loop
        contract (audio.cpp:774-779 keeps calling audio_codec_compress and
        sends EACH returned packet as its own RTP buffer).  Codecs whose
        decoder needs packet boundaries (Speex) override the lavc version;
        bytestream/one-packet-per-cycle codecs collapse to [compress()]."""
        out = self.compress(frame)
        if out is None or not any(len(c) for c in out.channels):
            return []
        return [out]

    def decompress(self, frame: AudioFrame) -> AudioFrame:
        raise NotImplementedError


class PcmCodec(AudioCodec):
    NAME = "PCM"

    def compress(self, frame: AudioFrame) -> AudioFrame:
        return frame

    def decompress(self, frame: AudioFrame) -> AudioFrame:
        return frame


def _linear_to_alaw(pcm16: np.ndarray) -> np.ndarray:
    """ITU-T G.711 A-law encode (vectorized)."""
    x = pcm16.astype(np.int32)
    sign = np.where(x >= 0, 0xD5, 0x55)
    mag = np.where(x >= 0, x, -x - 1).clip(0, 32767) >> 3  # 13-bit magnitude
    seg = np.zeros_like(mag)
    for s, lim in enumerate([31, 63, 127, 255, 511, 1023, 2047, 4095]):
        seg = np.where(mag > lim, s + 1, seg)
    seg = np.minimum(seg, 7)
    low = np.where(seg == 0, mag >> 1, mag >> seg)
    aval = (seg << 4) | (low & 0xF)
    return (aval ^ sign).astype(np.uint8)


def _alaw_to_linear(alaw: np.ndarray) -> np.ndarray:
    a = alaw.astype(np.int32) ^ 0x55
    sign = a & 0x80  # set = positive (A-law sign convention)
    seg = (a >> 4) & 0x7
    low = a & 0xF
    mag = np.where(seg == 0, (low << 1) + 1, ((low << 1) + 33) << (seg - 1))
    mag = mag << 3  # back to 16-bit scale (13-bit mag << 3)
    return np.where(sign, mag, -mag).astype(np.int16)


def _linear_to_mulaw(pcm16: np.ndarray) -> np.ndarray:
    """ITU-T G.711 u-law encode (14-bit algorithm, matches CPython audioop)."""
    x = pcm16.astype(np.int32) >> 2  # arithmetic shift to 14-bit
    mask = np.where(x < 0, 0x7F, 0xFF)
    mag = np.where(x < 0, -x, x).clip(0, 8159)
    mag = mag + (0x84 >> 2)  # bias 33 at 14-bit scale
    seg = np.zeros_like(mag)
    for s, lim in enumerate([0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF]):
        seg = np.where(mag > lim, s + 1, seg)
    segc = np.minimum(seg, 7)
    low = (mag >> (segc + 1)) & 0xF
    out = ((segc << 4) | low) ^ mask
    out = np.where(seg >= 8, 0x7F ^ mask, out)  # out-of-range clamp (audioop)
    return out.astype(np.uint8)


def _mulaw_to_linear(ulaw: np.ndarray) -> np.ndarray:
    BIAS = 0x84
    u = (~ulaw.astype(np.int32)) & 0xFF
    sign = u & 0x80
    seg = (u >> 4) & 0x7
    low = u & 0xF
    mag = (((low << 3) + BIAS) << seg) - BIAS
    return np.where(sign, -mag, mag).astype(np.int16)


class _G711Codec(AudioCodec):
    def _enc(self, pcm):
        raise NotImplementedError

    def _dec(self, enc):
        raise NotImplementedError

    def compress(self, frame: AudioFrame) -> AudioFrame:
        if frame.desc.bps != 2:
            raise ValueError("G.711 expects 16-bit PCM input")
        out_desc = frame.desc.with_(bps=1, codec=self.NAME)
        chans = []
        for c in frame.channels:
            pcm = np.frombuffer(c.tobytes(), "<i2")
            chans.append(self._enc(pcm))
        out = AudioFrame(out_desc, chans)
        out.timestamp = frame.timestamp
        return out

    def decompress(self, frame: AudioFrame) -> AudioFrame:
        out_desc = frame.desc.with_(bps=2, codec="PCM")
        chans = []
        for c in frame.channels:
            pcm = self._dec(np.asarray(c, np.uint8))
            chans.append(np.frombuffer(pcm.astype("<i2").tobytes(), np.uint8).copy())
        out = AudioFrame(out_desc, chans)
        out.timestamp = frame.timestamp
        return out


class AlawCodec(_G711Codec):
    NAME = "alaw"
    _enc = staticmethod(_linear_to_alaw)
    _dec = staticmethod(_alaw_to_linear)


class MulawCodec(_G711Codec):
    NAME = "ulaw"
    _enc = staticmethod(_linear_to_mulaw)
    _dec = staticmethod(_mulaw_to_linear)


_CODECS: Dict[str, Type[AudioCodec]] = {
    "PCM": PcmCodec,
    "alaw": AlawCodec,
    "ulaw": MulawCodec,
}


_INSTANCES: Dict[str, AudioCodec] = {}


def get_audio_codec(name: str) -> AudioCodec:
    cls = _CODECS.get(name)
    if cls is None:
        raise ValueError(
            f"audio codec {name!r} unavailable (supported: {sorted(_CODECS)})"
        )
    # one instance per name: packetized codecs (Opus...) keep encoder state
    # across audio cycles (ref: the codec state in audio/codec.c sessions)
    inst = _INSTANCES.get(name)
    if inst is None:
        inst = _INSTANCES[name] = cls()
    return inst


# the libavcodec-backed codecs (audio/lavc_codecs.py), registered where
# libavcodec's shim loads, as in the reference
from ultragrid_tpu_torch.audio.lavc_codecs import LAVC_CODECS, register_lavc_audio_codecs  # noqa: E402

LAVC_AUDIO_CODECS = tuple(cls.NAME for cls in LAVC_CODECS)
register_lavc_audio_codecs()
