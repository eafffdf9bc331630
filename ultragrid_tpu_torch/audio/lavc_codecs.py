"""libavcodec-backed audio codecs: Opus, G.722, MP3, AAC, FLAC.

Role analogue of the reference's libavcodec audio codec module
(src/audio/codec/libavcodec.c — the reference's Opus default voice codec
rides the same library).  Each channel is compressed independently as a
mono stream, matching the reference's per-channel audio_frame2 layout and
our 5-word audio RTP header (one encoded packet per channel per audio
cycle, so RTP buffer boundaries are packet boundaries).

G.722 (RFC 3551 PT 9) runs at 16 kHz; inputs at other rates are resampled
with the polyphase resampler first (the reference does the same through its
audio_frame2_resample path).

The port's copy of ``ultragrid_tpu/audio/lavc_codecs.py`` over the port's
shim (``native.lavc_shim_lib``); audio stays host numpy, as in the
reference.  :func:`register_lavc_audio_codecs` registers them under their
names where the shim loads, and only there, as the reference's does; a
codec class built where libavcodec is absent raises an error that names it.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List

import numpy as np

from ultragrid_tpu_torch import native
from ultragrid_tpu_torch.audio.resampler import resample_channel
from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("lavc-audio")


class LavcAudioCodec:
    """Stateful per-session codec (keep one instance per stream)."""

    NAME = "?"
    ENC = "?"
    DEC = "?"
    RATE = 0          # required sample rate (0 = any)
    BITRATE = 128000
    ENC_OPTS = ""

    def __init__(self) -> None:
        if not native.lavc_headers_present():
            raise ValueError(f"audio codec {self.NAME!r} needs libavcodec, whose FFmpeg headers are absent")
        self._lib = native.lavc_shim_lib()
        self._enc: Dict[int, int] = {}
        self._dec: Dict[int, int] = {}
        self._pending: Dict[int, np.ndarray] = {}
        self._rate = 0

    # -- helpers ---------------------------------------------------------

    def _to_s16(self, frame: AudioFrame, ch: int) -> np.ndarray:
        data = np.asarray(frame.channels[ch], np.uint8)
        bps = frame.desc.bps
        if bps == 2:
            return data.view("<i2")
        if bps == 1:
            return (data.astype(np.int16) - 128) << 8
        if bps == 4:
            return (data.view("<i4") >> 16).astype(np.int16)
        raise ValueError(f"bps {bps}")

    def _resample(self, s16: np.ndarray, from_rate: int, to_rate: int) -> np.ndarray:
        if from_rate == to_rate:
            return s16
        fr = Fraction(to_rate, from_rate)
        y = resample_channel(s16.astype(np.float64), fr.numerator, fr.denominator)
        return np.clip(y, -32768, 32767).astype("<i2")

    # -- codec API (matches audio/codecs.py AudioCodec) -------------------

    def _compress_packets(self, frame: AudioFrame):
        """Encode one audio cycle; returns (desc, per-channel packet lists)."""
        desc = frame.desc
        rate = self.RATE or desc.sample_rate
        if self._rate and self._rate != rate:
            self._close_all()
        self._rate = rate
        out_pkts: List[List[np.ndarray]] = []
        for ch in range(len(frame.channels)):
            s16 = self._to_s16(frame, ch)
            s16 = self._resample(s16, desc.sample_rate, rate)
            h = self._enc.get(ch)
            if h is None:
                h = self._lib.lavc_aenc_open(
                    self.ENC.encode(), rate, 1, self.BITRATE, self.ENC_OPTS.encode()
                )
                if not h:
                    raise ValueError(f"cannot open {self.ENC} encoder")
                self._enc[ch] = h
            fs = self._lib.lavc_aenc_frame_size(h)
            pend = self._pending.get(ch)
            if pend is not None and pend.size:
                s16 = np.concatenate([pend, s16])
            out = np.empty(s16.size * 2 + 4096, np.uint8)
            pkts: List[np.ndarray] = []
            if fs <= 0:
                s16c = np.ascontiguousarray(s16)
                n = self._lib.lavc_aenc_encode(
                    h, s16c.ctypes.data, s16c.size, out.ctypes.data, out.size
                )
                if n > 0:
                    pkts.append(out[: int(n)].copy())
                self._pending[ch] = np.empty(0, "<i2")
            else:
                pos = 0
                while s16.size - pos >= fs:
                    chunk = np.ascontiguousarray(s16[pos : pos + fs])
                    n = self._lib.lavc_aenc_encode(
                        h, chunk.ctypes.data, fs, out.ctypes.data, out.size
                    )
                    if n > 0:
                        pkts.append(out[: int(n)].copy())
                    pos += fs
                self._pending[ch] = s16[pos:].copy()
            out_pkts.append(pkts)
        ndesc = AudioDesc(bps=desc.bps, sample_rate=rate,
                          ch_count=desc.ch_count, codec=self.NAME)
        return ndesc, out_pkts

    def compress(self, frame: AudioFrame) -> AudioFrame:
        ndesc, out_pkts = self._compress_packets(frame)
        nf = AudioFrame(ndesc, [
            np.concatenate(pkts) if pkts else np.empty(0, np.uint8)
            for pkts in out_pkts
        ])
        nf.timestamp = frame.timestamp
        return nf

    def compress_multi(self, frame: AudioFrame) -> list:
        """One AudioFrame per encoder packet (reference compress-loop
        semantics — needed by Speex, whose lavc decoder takes exactly one
        20 ms frame per packet).  Per-channel packet counts match because
        every channel sees the same sample count and encoder params."""
        ndesc, out_pkts = self._compress_packets(frame)
        if not out_pkts or not out_pkts[0]:
            return []
        n = min(len(p) for p in out_pkts)
        frames = []
        for i in range(n):
            nf = AudioFrame(ndesc, [pkts[i] for pkts in out_pkts])
            nf.timestamp = frame.timestamp
            frames.append(nf)
        return frames

    def decompress(self, frame: AudioFrame) -> AudioFrame:
        desc = frame.desc
        rate = self.RATE or desc.sample_rate
        out_channels: List[np.ndarray] = []
        for ch in range(len(frame.channels)):
            data = np.ascontiguousarray(np.asarray(frame.channels[ch], np.uint8))
            h = self._dec.get(ch)
            if h is None:
                h = self._lib.lavc_adec_open(self.DEC.encode(), rate, 1)
                if not h:
                    raise ValueError(f"cannot open {self.DEC} decoder")
                self._dec[ch] = h
            cap = max(rate, 48000) * 4  # generous
            out = np.empty(cap, "<i2")
            n = self._lib.lavc_adec_decode(
                h, data.ctypes.data, data.size, out.ctypes.data, cap
            )
            if n < 0:
                raise ValueError(f"{self.NAME} decode failed")
            out_channels.append(out[: int(n)].copy().view(np.uint8))
        ndesc = AudioDesc(bps=2, sample_rate=rate,
                          ch_count=desc.ch_count, codec="PCM")
        nf = AudioFrame(ndesc, out_channels)
        nf.timestamp = frame.timestamp
        return nf

    def _close_all(self) -> None:
        for h in list(self._enc.values()) + list(self._dec.values()):
            self._lib.lavc_acod_close(h)
        self._enc.clear()
        self._dec.clear()
        self._pending.clear()

    def __del__(self):  # best effort
        try:
            self._close_all()
        except Exception:  # noqa: BLE001
            pass


class OpusCodec(LavcAudioCodec):
    """The reference's default voice codec (ref: audio/codec.h:53-95)."""

    NAME = "Opus"
    ENC = "libopus"
    DEC = "libopus"
    RATE = 48000
    BITRATE = 128000
    # 40 ms frames = one packet per 1/25 s audio cycle, so RTP buffer
    # boundaries are packet boundaries (no extra framing needed)
    ENC_OPTS = "frame_duration=40"


class G722Codec(LavcAudioCodec):
    """RFC 3551 PT 9 wideband ADPCM; byte-stream, 16 kHz."""

    NAME = "G722"
    ENC = "g722"
    DEC = "g722"
    RATE = 16000
    BITRATE = 64000


class SpeexCodec(LavcAudioCodec):
    """Speex wideband via libspeex — the reference ships it both ways
    through the same lavc module (marked deprecated there but still
    selectable; ref: src/audio/codec/libavcodec.c:97,796).  20 ms frames
    at 16 kHz (320 samples) so a 40 ms audio cycle yields whole packets."""

    NAME = "speex"
    ENC = "libspeex"
    DEC = "libspeex"
    RATE = 16000
    BITRATE = 24600  # libspeex wideband quality-8 default


class Mp3Codec(LavcAudioCodec):
    NAME = "MP3"
    ENC = "libmp3lame"
    DEC = "mp3"
    RATE = 48000
    BITRATE = 192000


class AacCodec(LavcAudioCodec):
    NAME = "AAC"
    ENC = "aac"
    DEC = "aac"
    RATE = 48000
    BITRATE = 192000


class FlacCodec(LavcAudioCodec):
    NAME = "FLAC"
    ENC = "flac"
    DEC = "flac"
    RATE = 0
    BITRATE = 0


LAVC_CODECS = (OpusCodec, G722Codec, SpeexCodec, Mp3Codec, AacCodec, FlacCodec)


def register_lavc_audio_codecs() -> None:
    """Register :data:`LAVC_CODECS` beside PCM, A-law and mu-law where the
    shim loads (ref ``register_lavc_audio_codecs``, lavc_codecs.py:247):
    nothing where the FFmpeg headers are absent or the loader gives no
    library, and no name already registered is replaced."""
    if not native.lavc_headers_present() or native.lavc_shim_lib() is None:
        return
    from ultragrid_tpu_torch.audio import codecs

    for cls in LAVC_CODECS:
        codecs._CODECS.setdefault(cls.NAME, cls)
