"""The port's ALSA modules against an in-process fake kernel PCM device,
beside the JAX package's.

The fakes of ``tests/test_alsa.py``: the hw_params/sw_params/readi/writei
ioctl surface of /dev/snd/pcmC0D0{c,p} (sound/asound.h), an injected xrun
so the EPIPE re-prepare recovery runs.  Every case runs against the port's
``audio/alsa.py`` and the reference's, and each fake also logs the ioctl
requests and the bytes of their structures: the two logs are equal, so the
port speaks to the kernel exactly as the reference does.  Where no device
exists, both raise the reference's error; the port has no dummy in its place.
"""

from __future__ import annotations

import ctypes
import errno
import os

import numpy as np
import pytest

pytest.importorskip("torch")

import ultragrid_tpu.audio.alsa as ref_alsa  # noqa: E402
from ultragrid_tpu.audio.types import AudioDesc as RefDesc  # noqa: E402
from ultragrid_tpu.audio.types import AudioFrame as RefFrame  # noqa: E402

import ultragrid_tpu_torch.audio.alsa as alsa  # noqa: E402
from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame  # noqa: E402

PKGS = {"port": (alsa, AudioDesc, AudioFrame), "ref": (ref_alsa, RefDesc, RefFrame)}


class FakePcm:
    def __init__(self, mod, stream: str = "c", rate: int = 48000):
        self.mod = mod
        self.stream = stream
        self.rate = rate
        self.fd = os.open("/dev/null", os.O_RDWR)
        self.state = "open"
        self.read_counter = 0
        self.written = bytearray()
        self.xrun_after = None  # inject EPIPE on the n-th xfer
        self.xfers = 0
        self.prepares = 0
        self.hw = None
        self.log = []  # (request, the structure's bytes as given)

    def open(self, path, flags):
        assert path == f"/dev/snd/pcmC0D0{self.stream}", path
        return self.fd

    def ioctl(self, fd, req, arg=0, mutate=True):
        assert fd == self.fd
        a = self.mod
        if req in (a.SNDRV_PCM_IOCTL_READI_FRAMES, a.SNDRV_PCM_IOCTL_WRITEI_FRAMES):
            self.log.append((req, arg.frames))  # the buffer address differs run to run
        else:
            self.log.append((req, bytes(arg) if isinstance(arg, ctypes.Structure) else arg))
        if req == a.SNDRV_PCM_IOCTL_HW_PARAMS:
            # the kernel chooses: honor requested rate/channels, pick the
            # lowest requested period size, derive buffer = 4 periods
            ch = arg.intervals[a.I_CHANNELS].min
            rate = arg.intervals[a.I_RATE].min
            psize = arg.intervals[a.I_PERIOD_SIZE].min
            if rate == 44100 and self.rate != 44100:
                raise OSError(errno.EINVAL, "rate not supported")
            arg.intervals[a.I_RATE].min = arg.intervals[a.I_RATE].max = rate
            arg.intervals[a.I_PERIOD_SIZE].max = psize
            bsz = a.I_BUFFER_SIZE
            arg.intervals[bsz].min = arg.intervals[bsz].max = psize * 4
            self.hw = (rate, ch, psize)
            self.state = "setup"
        elif req == a.SNDRV_PCM_IOCTL_SW_PARAMS:
            assert arg.boundary > 0
            self.sw = (arg.start_threshold, arg.stop_threshold)
        elif req == a.SNDRV_PCM_IOCTL_PREPARE:
            self.state = "prepared"
            self.prepares += 1
        elif req == a.SNDRV_PCM_IOCTL_DRAIN:
            pass
        elif req in (a.SNDRV_PCM_IOCTL_READI_FRAMES, a.SNDRV_PCM_IOCTL_WRITEI_FRAMES):
            self.xfers += 1
            if self.xrun_after is not None and self.xfers > self.xrun_after:
                self.xrun_after = None
                self.state = "xrun"
                raise OSError(errno.EPIPE, "xrun")
            assert self.state == "prepared", self.state
            _, ch, _ = self.hw
            nbytes = arg.frames * ch * 2
            if req == a.SNDRV_PCM_IOCTL_READI_FRAMES:
                # deterministic s16 ramp so content can be asserted
                data = (np.arange(self.read_counter, self.read_counter + arg.frames * ch,
                                  dtype=np.int16)).tobytes()
                self.read_counter += arg.frames * ch
                ctypes.memmove(arg.buf, data, nbytes)
            else:
                self.written += ctypes.string_at(arg.buf, nbytes)
            arg.result = arg.frames
        else:
            raise OSError(errno.EINVAL, f"unexpected ioctl 0x{req:08x}")
        return 0


def fake(monkeypatch, pkg, stream):
    mod = PKGS[pkg][0]
    pcm = FakePcm(mod, stream)
    monkeypatch.setattr(mod, "_ioctl", pcm.ioctl)
    monkeypatch.setattr(mod, "_open", pcm.open)
    monkeypatch.setattr(mod, "probe_devices", lambda s: [f"/dev/snd/pcmC0D0{s}"])
    return pcm


def test_uapi_layout_equals_reference():
    for name in ("snd_pcm_hw_params", "snd_pcm_sw_params", "snd_xferi", "snd_mask", "snd_interval"):
        assert ctypes.sizeof(getattr(alsa, name)) == ctypes.sizeof(getattr(ref_alsa, name)), name
    for name in dir(ref_alsa):
        if name.startswith(("SNDRV_", "I_", "PARAM_", "FORMAT_", "ACCESS_", "SUBFORMAT_", "INTERVAL_")):
            assert getattr(alsa, name) == getattr(ref_alsa, name), name
    assert bytes(alsa._params_any()) == bytes(ref_alsa._params_any())


def capture_run(monkeypatch, pkg):
    pcm = fake(monkeypatch, pkg, "c")
    cap = PKGS[pkg][0].AlsaAudioCapture("frames=64")
    f = cap.read(32)
    cap.done()
    return pcm, cap, f


def test_capture_negotiate_and_read(monkeypatch):
    pcm, cap, f = capture_run(monkeypatch, "port")
    ref_pcm, ref_cap, ref_f = capture_run(monkeypatch, "ref")
    assert pcm.log == ref_pcm.log
    assert pcm.hw == (48000, 2, 64) and cap.desc.sample_rate == 48000
    assert pcm.sw == (1, 64 * 4)  # capture starts on first read; stop at the buffer size
    assert f is not None and f.sample_count == 32
    assert list(f.channels[0].view(np.int16)[:4]) == [0, 2, 4, 6]
    assert list(f.channels[1].view(np.int16)[:4]) == [1, 3, 5, 7]
    for c in range(2):
        assert np.array_equal(f.channels[c], ref_f.channels[c])


def test_capture_honours_the_capture_format(monkeypatch):
    from ultragrid_tpu_torch.audio import capture

    capture.set_audio_capture_format("channels=1")
    try:
        pcm = fake(monkeypatch, "port", "c")
        cap = alsa.AlsaAudioCapture("")
        assert pcm.hw == (48000, 1, 128) and cap.desc.ch_count == 1
        cap.done()
    finally:
        capture._capture_format.clear()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_capture_xrun_recovery(monkeypatch, pkg):
    pcm = fake(monkeypatch, pkg, "c")
    cap = PKGS[pkg][0].AlsaAudioCapture("")
    pcm.xrun_after = 0  # next xfer raises EPIPE
    f = cap.read(16)
    assert f is not None and f.sample_count == 16
    assert pcm.prepares == 2  # init + recovery re-prepare
    cap.done()


def playback_run(monkeypatch, pkg):
    mod, desc_cls, frame_cls = PKGS[pkg]
    pcm = fake(monkeypatch, pkg, "p")
    pb = mod.AlsaAudioPlayback("dev=hw:0,0:frames=32")
    desc = desc_cls(bps=2, sample_rate=48000, ch_count=2)
    pb.reconfigure(desc)
    samples = np.arange(2 * 100, dtype=np.int16)
    pb.put_frame(frame_cls.from_interleaved(desc, samples.view(np.uint8)))
    pb.done()
    return pcm, samples


def test_playback_roundtrip(monkeypatch):
    pcm, samples = playback_run(monkeypatch, "port")
    ref_pcm, _ = playback_run(monkeypatch, "ref")
    assert pcm.log == ref_pcm.log
    assert pcm.sw[0] == 32  # playback starts once a period is queued
    assert np.array_equal(np.frombuffer(bytes(pcm.written), np.int16), samples)
    assert pcm.written == ref_pcm.written


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_rate_refusal(monkeypatch, pkg):
    mod, desc_cls, _ = PKGS[pkg]
    fake(monkeypatch, pkg, "c")
    with pytest.raises(RuntimeError, match="hw_params refused"):
        mod.AlsaAudioCapture("", desc=desc_cls(sample_rate=44100))


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_probe_failure(monkeypatch, pkg):
    """No /dev/snd device: the reference's error, never a dummy device."""
    mod = PKGS[pkg][0]
    monkeypatch.setattr(mod, "probe_devices", lambda s: [])
    with pytest.raises(RuntimeError, match="no /dev/snd"):
        mod.AlsaAudioCapture("")
    with pytest.raises(RuntimeError, match="no /dev/snd"):
        mod.AlsaAudioPlayback("")


def test_registry_refuses_a_missing_device(monkeypatch):
    from ultragrid_tpu_torch.audio.capture import initialize_audio_capture
    from ultragrid_tpu_torch.audio.playback import initialize_audio_playback

    monkeypatch.setattr(alsa, "probe_devices", lambda s: [])
    with pytest.raises(RuntimeError, match="no /dev/snd"):
        initialize_audio_capture("alsa")
    with pytest.raises(RuntimeError, match="no /dev/snd"):
        initialize_audio_playback("alsa")


@pytest.mark.parametrize("dev,want", [("hw:1,2", (1, 2)), ("hw:3", (3, 0)), ("default", (0, 0)), ("", (0, 0))])
def test_device_parsing(dev, want):
    assert alsa.parse_device(dev) == ref_alsa.parse_device(dev) == want


@pytest.mark.parametrize("cfg", ["", "frames=256", "dev=hw:1,0:frames=64", "hw:2,1", "device=hw:0,3"])
def test_config_parsing(cfg):
    assert alsa._parse_cfg(cfg) == ref_alsa._parse_cfg(cfg)
