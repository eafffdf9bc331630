"""ALSA audio capture + playback via the kernel PCM UAPI (no libasound).

Parity with the reference's ALSA modules (ref: src/audio/capture/alsa.c,
src/audio/playback/alsa.c): open the PCM device, negotiate interleaved
S16/S32 access + rate + channels through hw_params, set start/stop
thresholds through sw_params, then snd_pcm_readi/writei-equivalent frame
I/O with overrun/underrun (EPIPE) recovery via re-prepare.

Implemented pure-ctypes against ``/dev/snd/pcmC*D*{c,p}`` (sound/asound.h
ioctls) — the same no-userspace-library strategy as the v4l2 capture and
drm display.  Without /dev/snd the module init fails with a clear probe
message (the reference behaves the same when no card is present).

Config: ``alsa[:dev=hw:C,D][:frames=N]`` (frames = period size, default
128 like the reference, alsa.c:156).

The port's copy of ``ultragrid_tpu/audio/alsa.py``.
"""

from __future__ import annotations

import ctypes
import glob
import os
from fcntl import ioctl as _fcntl_ioctl
from typing import List, Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("alsa")

# test seams (the fake PCM device in tests swaps these)
_ioctl = _fcntl_ioctl
_open = os.open


# ---------------------------------------------------------------------------
# sound/asound.h UAPI — stable kernel ABI
# ---------------------------------------------------------------------------


class snd_mask(ctypes.Structure):
    _fields_ = [("bits", ctypes.c_uint32 * 8)]


class snd_interval(ctypes.Structure):
    # min/max + packed bitfields openmin/openmax/integer/empty
    _fields_ = [
        ("min", ctypes.c_uint32),
        ("max", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
    ]


INTERVAL_INTEGER = 1 << 2  # the 'integer' bitfield


class snd_pcm_hw_params(ctypes.Structure):
    _fields_ = [
        ("flags", ctypes.c_uint32),
        ("masks", snd_mask * 3),       # ACCESS, FORMAT, SUBFORMAT
        ("mres", snd_mask * 5),
        ("intervals", snd_interval * 12),  # SAMPLE_BITS..TICK_TIME
        ("ires", snd_interval * 9),
        ("rmask", ctypes.c_uint32),
        ("cmask", ctypes.c_uint32),
        ("info", ctypes.c_uint32),
        ("msbits", ctypes.c_uint32),
        ("rate_num", ctypes.c_uint32),
        ("rate_den", ctypes.c_uint32),
        ("fifo_size", ctypes.c_ulong),
        ("reserved", ctypes.c_uint8 * 64),
    ]


class snd_pcm_sw_params(ctypes.Structure):
    _fields_ = [
        ("tstamp_mode", ctypes.c_int32),
        ("period_step", ctypes.c_uint32),
        ("sleep_min", ctypes.c_uint32),
        ("avail_min", ctypes.c_ulong),
        ("xfer_align", ctypes.c_ulong),
        ("start_threshold", ctypes.c_ulong),
        ("stop_threshold", ctypes.c_ulong),
        ("silence_threshold", ctypes.c_ulong),
        ("silence_size", ctypes.c_ulong),
        ("boundary", ctypes.c_ulong),
        ("proto", ctypes.c_uint32),
        ("tstamp_type", ctypes.c_uint32),
        ("reserved", ctypes.c_uint8 * 56),
    ]


class snd_xferi(ctypes.Structure):
    _fields_ = [
        ("result", ctypes.c_long),
        ("buf", ctypes.c_void_p),
        ("frames", ctypes.c_ulong),
    ]


def _IOC(direction: int, nr: int, size: int) -> int:
    return (direction << 30) | (size << 16) | (ord("A") << 8) | nr


SNDRV_PCM_IOCTL_HW_REFINE = _IOC(3, 0x10, ctypes.sizeof(snd_pcm_hw_params))
SNDRV_PCM_IOCTL_HW_PARAMS = _IOC(3, 0x11, ctypes.sizeof(snd_pcm_hw_params))
SNDRV_PCM_IOCTL_SW_PARAMS = _IOC(3, 0x13, ctypes.sizeof(snd_pcm_sw_params))
SNDRV_PCM_IOCTL_PREPARE = _IOC(0, 0x40, 0)
SNDRV_PCM_IOCTL_START = _IOC(0, 0x42, 0)
SNDRV_PCM_IOCTL_DRAIN = _IOC(0, 0x44, 0)
SNDRV_PCM_IOCTL_WRITEI_FRAMES = _IOC(1, 0x50, ctypes.sizeof(snd_xferi))
SNDRV_PCM_IOCTL_READI_FRAMES = _IOC(2, 0x51, ctypes.sizeof(snd_xferi))

# hw_params mask indices
PARAM_ACCESS, PARAM_FORMAT, PARAM_SUBFORMAT = 0, 1, 2
# hw_params interval indices (relative to FIRST_INTERVAL == SAMPLE_BITS == 8)
I_SAMPLE_BITS, I_FRAME_BITS, I_CHANNELS, I_RATE = 0, 1, 2, 3
I_PERIOD_TIME, I_PERIOD_SIZE, I_PERIOD_BYTES, I_PERIODS = 4, 5, 6, 7
I_BUFFER_TIME, I_BUFFER_SIZE, I_BUFFER_BYTES, I_TICK_TIME = 8, 9, 10, 11

ACCESS_RW_INTERLEAVED = 3
SUBFORMAT_STD = 0
# SNDRV_PCM_FORMAT_*: bps bytes -> format id (ref alsa.c bps_to_snd_fmts)
FORMAT_FOR_BPS = {1: 1, 2: 2, 3: 32, 4: 10}  # U8, S16_LE, S24_3LE, S32_LE

EPIPE = 32


def _params_any() -> snd_pcm_hw_params:
    """All masks full, all intervals unbounded (snd_pcm_hw_params_any)."""
    p = snd_pcm_hw_params()
    p.rmask = 0xFFFFFFFF
    for m in list(p.masks) + list(p.mres):
        for i in range(8):
            m.bits[i] = 0xFFFFFFFF
    for iv in list(p.intervals) + list(p.ires):
        iv.min, iv.max, iv.flags = 0, 0xFFFFFFFF, 0
    return p


def _set_mask(p: snd_pcm_hw_params, idx: int, bit: int) -> None:
    m = p.masks[idx]
    for i in range(8):
        m.bits[i] = 0
    m.bits[bit // 32] = 1 << (bit % 32)


def _set_interval(p: snd_pcm_hw_params, idx: int, lo: int,
                  hi: Optional[int] = None) -> None:
    iv = p.intervals[idx]
    iv.min, iv.max = lo, lo if hi is None else hi
    iv.flags = INTERVAL_INTEGER


def parse_device(dev: str) -> Tuple[int, int]:
    """'hw:C,D' / 'hw:C' / 'default' -> (card, device)."""
    if dev in ("", "default"):
        return 0, 0
    body = dev[3:] if dev.startswith("hw:") else dev
    card, _, sub = body.partition(",")
    return int(card or 0), int(sub or 0)


def probe_devices(stream: str) -> List[str]:
    """stream: 'c' capture / 'p' playback."""
    return sorted(glob.glob(f"/dev/snd/pcmC*D*{stream}"))


class AlsaPcm:
    """One PCM substream in interleaved RW mode."""

    def __init__(self, dev: str, stream: str, rate: int, channels: int,
                 bps: int, period_frames: int):
        if dev:
            card, sub = parse_device(dev)
            path = f"/dev/snd/pcmC{card}D{sub}{stream}"
        else:
            devs = probe_devices(stream)
            if not devs:
                kind = "capture" if stream == "c" else "playback"
                raise RuntimeError(
                    f"alsa: no /dev/snd/pcm*{stream} {kind} device present "
                    "(probe failed)")
            path = devs[0]
        self.fd = _open(path, os.O_RDWR)
        self.stream = stream
        self.bps, self.channels = bps, channels

        if bps not in FORMAT_FOR_BPS:
            raise RuntimeError(f"alsa: unsupported sample size {bps} B")
        p = _params_any()
        _set_mask(p, PARAM_ACCESS, ACCESS_RW_INTERLEAVED)
        _set_mask(p, PARAM_FORMAT, FORMAT_FOR_BPS[bps])
        _set_mask(p, PARAM_SUBFORMAT, SUBFORMAT_STD)
        _set_interval(p, I_SAMPLE_BITS, bps * 8)
        _set_interval(p, I_FRAME_BITS, bps * 8 * channels)
        _set_interval(p, I_CHANNELS, channels)
        _set_interval(p, I_RATE, rate)
        _set_interval(p, I_PERIOD_SIZE, period_frames, period_frames * 2)
        _set_interval(p, I_PERIODS, 2, 64)
        try:
            _ioctl(self.fd, SNDRV_PCM_IOCTL_HW_PARAMS, p)
        except OSError as e:
            os.close(self.fd)
            raise RuntimeError(f"alsa: hw_params refused "
                               f"{rate} Hz/{channels} ch/{bps * 8}-bit: {e}")
        self.rate = p.intervals[I_RATE].min
        self.period_size = p.intervals[I_PERIOD_SIZE].min
        self.buffer_size = p.intervals[I_BUFFER_SIZE].min

        sw = snd_pcm_sw_params()
        sw.period_step = 1
        sw.avail_min = self.period_size
        # capture starts on first read; playback once a period is queued
        sw.start_threshold = 1 if stream == "c" else self.period_size
        sw.stop_threshold = self.buffer_size
        boundary = self.buffer_size or 1
        while boundary * 2 <= (1 << 62):
            boundary *= 2
        sw.boundary = boundary
        sw.xfer_align = 1
        try:
            _ioctl(self.fd, SNDRV_PCM_IOCTL_SW_PARAMS, sw)
            _ioctl(self.fd, SNDRV_PCM_IOCTL_PREPARE)
        except OSError:
            os.close(self.fd)
            raise
        log.notice(f"{path}: {self.rate} Hz, {channels} ch, {bps * 8}-bit, "
                   f"period {self.period_size}")

    def _xfer(self, req: int, buf: np.ndarray, frames: int) -> int:
        x = snd_xferi()
        x.buf = buf.ctypes.data
        x.frames = frames
        try:
            _ioctl(self.fd, req, x)
        except OSError as e:
            if e.errno == EPIPE:  # over/underrun: re-prepare and retry once
                log.warning("xrun, recovering")
                _ioctl(self.fd, SNDRV_PCM_IOCTL_PREPARE)
                _ioctl(self.fd, req, x)
            else:
                raise
        return int(x.result)

    def readi(self, frames: int) -> np.ndarray:
        buf = np.zeros(frames * self.channels * self.bps, np.uint8)
        got = self._xfer(SNDRV_PCM_IOCTL_READI_FRAMES, buf, frames)
        return buf[: got * self.channels * self.bps]

    def writei(self, data: np.ndarray) -> int:
        data = np.ascontiguousarray(data, np.uint8)
        frames = data.size // (self.channels * self.bps)
        done = 0
        while done < frames:
            chunk = data[done * self.channels * self.bps:]
            done += self._xfer(SNDRV_PCM_IOCTL_WRITEI_FRAMES, chunk,
                               frames - done)
        return done

    def close(self, drain: bool = False) -> None:
        try:
            if drain:
                _ioctl(self.fd, SNDRV_PCM_IOCTL_DRAIN)
        except OSError:
            pass
        os.close(self.fd)


def _parse_cfg(cfg: str) -> Tuple[str, int]:
    dev, frames = "", 128
    toks = [t for t in cfg.split(":") if t]
    i = 0
    while i < len(toks):
        key, _, val = toks[i].partition("=")
        # 'hw:C,D' device names contain a colon: rejoin the split halves
        if val == "hw" or (key == "hw" and not val):
            if i + 1 < len(toks) and "=" not in toks[i + 1]:
                val = f"hw:{toks[i + 1]}"
                i += 1
            else:
                val = "hw:0,0"
        if key in ("dev", "device", "hw"):
            dev = val
        elif key == "frames":
            frames = int(val)
        i += 1
    return dev, frames


class AlsaAudioCapture:
    """``--audio-capture alsa`` (ref: src/audio/capture/alsa.c)."""

    def __init__(self, cfg: str = "", desc: Optional[AudioDesc] = None):
        dev, frames = _parse_cfg(cfg)
        if desc is None:  # honor -a/--audio-capture-format overrides
            from ultragrid_tpu_torch.audio.capture import default_capture_desc

            desc = default_capture_desc()
        d = desc
        self.pcm = AlsaPcm(dev, "c", d.sample_rate, d.ch_count, d.bps, frames)
        self.desc = AudioDesc(bps=d.bps, sample_rate=self.pcm.rate,
                              ch_count=d.ch_count)

    def read(self, nsamples: int) -> Optional[AudioFrame]:
        raw = self.pcm.readi(nsamples)
        if raw.size == 0:
            return None
        return AudioFrame.from_interleaved(self.desc, raw)

    def done(self) -> None:
        self.pcm.close()


class AlsaAudioPlayback:
    """``--audio-playback alsa`` (ref: src/audio/playback/alsa.c)."""

    def __init__(self, cfg: str = ""):
        self.dev, self.frames = _parse_cfg(cfg)
        self.pcm: Optional[AlsaPcm] = None
        self.desc: Optional[AudioDesc] = None
        if not self.dev and not probe_devices("p"):
            raise RuntimeError(
                "alsa: no /dev/snd/pcm*p playback device present (probe failed)")

    def reconfigure(self, desc: AudioDesc) -> bool:
        if self.pcm is not None:
            self.pcm.close()
        self.pcm = AlsaPcm(self.dev, "p", desc.sample_rate, desc.ch_count,
                           desc.bps, self.frames)
        self.desc = desc
        return True

    def put_frame(self, frame: Optional[AudioFrame]) -> None:
        if frame is None or self.pcm is None:
            return
        self.pcm.writei(frame.to_interleaved())

    def done(self) -> None:
        if self.pcm is not None:
            self.pcm.close(drain=True)


register_module("alsa", LibraryClass.AUDIO_CAPTURE, AlsaAudioCapture)
register_module("alsa", LibraryClass.AUDIO_PLAYBACK, AlsaAudioPlayback)
