"""fluidsynth-counterpart audio capture: Standard-MIDI-File software synth.

The reference bundles fluidsynth + embedded MIDI songs as an audio source
(ref: src/audio/capture/fluidsynth.c — grammar
``fluidsynth[:file=<filename>|song=<idx>][:loop=<iter>]``, bundled song 1 by
default).  No fluidsynth/soundfont exists in this environment, so this
module implements the whole path from scratch:

* a minimal SMF parser (format 0/1, running status, tempo meta events),
* a polyphonic additive synth (3 harmonics, exponential decay, velocity
  scaled) rendered vectorized with numpy,
* a bundled song *generated programmatically* (a small arpeggio piece) —
  not a copy of the reference's embedded binaries.

Registered as both ``fluidsynth`` (reference name) and ``midi``.

The port's copy of ``ultragrid_tpu/audio/midi_synth.py``.
"""

from __future__ import annotations

import io
import math
import struct
import time
from typing import List, Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.audio.capture import AudioCapture
from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("fluidsynth")


# -- SMF parsing -------------------------------------------------------------


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    val = 0
    while True:
        b = data[pos]
        pos += 1
        val = (val << 7) | (b & 0x7F)
        if not b & 0x80:
            return val, pos


def parse_smf(data: bytes) -> List[Tuple[float, int, int, int]]:
    """SMF bytes -> [(time_seconds, channel, note, velocity)] note events.

    velocity 0 = note off.  Handles format 0/1, running status, and tempo
    changes (meta 0x51); other events are skipped structurally.
    """
    if data[:4] != b"MThd":
        raise ValueError("not a MIDI file")
    hlen, fmt, ntrk, division = struct.unpack(">IHHH", data[4:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division unsupported")
    pos = 8 + hlen
    tracks = []
    for _ in range(ntrk):
        if data[pos : pos + 4] != b"MTrk":
            raise ValueError("bad track chunk")
        tlen = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        tracks.append(data[pos + 8 : pos + 8 + tlen])
        pos += 8 + tlen

    # gather (tick, kind, payload) across tracks; tempo map applies globally
    raw = []  # (tick, order, type, ch, a, b)
    for ti, trk in enumerate(tracks):
        p = 0
        tick = 0
        status = 0
        while p < len(trk):
            delta, p = _read_varlen(trk, p)
            tick += delta
            b0 = trk[p]
            if b0 & 0x80:
                status = b0
                p += 1
            if status == 0xFF:  # meta
                mtype = trk[p]
                mlen, p2 = _read_varlen(trk, p + 1)
                payload = trk[p2 : p2 + mlen]
                p = p2 + mlen
                if mtype == 0x51 and mlen == 3:
                    uspq = (payload[0] << 16) | (payload[1] << 8) | payload[2]
                    raw.append((tick, ti, "tempo", 0, uspq, 0))
                continue
            if status in (0xF0, 0xF7):  # sysex
                mlen, p2 = _read_varlen(trk, p)
                p = p2 + mlen
                continue
            kind = status & 0xF0
            ch = status & 0x0F
            if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                a, b = trk[p], trk[p + 1]
                p += 2
                if kind == 0x90:
                    raw.append((tick, ti, "note", ch, a, b))
                elif kind == 0x80:
                    raw.append((tick, ti, "note", ch, a, 0))
            elif kind in (0xC0, 0xD0):
                p += 1
    raw.sort(key=lambda e: (e[0], e[1]))

    # ticks -> seconds through the tempo map (default 120 bpm = 500000 us/q)
    events = []
    uspq = 500000
    last_tick = 0
    t = 0.0
    for tick, _ti, typ, ch, a, b in raw:
        t += (tick - last_tick) * uspq / 1e6 / division
        last_tick = tick
        if typ == "tempo":
            uspq = a
        else:
            events.append((t, ch, a, b))
    return events


# -- bundled song (programmatic, not a reference copy) -----------------------


def _bundled_song() -> bytes:
    """A small format-0 SMF: I-vi-IV-V arpeggio loop with a bass line."""
    out = io.BytesIO()
    division = 480

    def varlen(v: int) -> bytes:
        chunks = [v & 0x7F]
        v >>= 7
        while v:
            chunks.append((v & 0x7F) | 0x80)
            v >>= 7
        return bytes(reversed(chunks))

    ev = []  # (tick, bytes)
    chords = [(60, 64, 67), (57, 60, 64), (53, 57, 60), (55, 59, 62)]
    tick = 0
    for bar in range(4):
        root, third, fifth = chords[bar]
        bass = root - 24
        ev.append((tick, bytes([0x90, bass, 0x50])))
        ev.append((tick + 4 * division - 10, bytes([0x80, bass, 0x00])))
        arp = [root, third, fifth, third, root + 12, fifth, third, fifth]
        for i, note in enumerate(arp):
            t0 = tick + i * division // 2
            ev.append((t0, bytes([0x90, note, 0x60])))
            ev.append((t0 + division // 2 - 5, bytes([0x80, note, 0x00])))
        tick += 4 * division
    ev.sort(key=lambda e: e[0])
    trk = io.BytesIO()
    trk.write(varlen(0) + b"\xff\x51\x03" + (500000).to_bytes(3, "big"))
    last = 0
    for t, msg in ev:
        trk.write(varlen(t - last) + msg)
        last = t
    trk.write(varlen(0) + b"\xff\x2f\x00")
    body = trk.getvalue()
    out.write(b"MThd" + struct.pack(">IHHH", 6, 0, 1, division))
    out.write(b"MTrk" + struct.pack(">I", len(body)) + body)
    return out.getvalue()


# -- synth -------------------------------------------------------------------


def render_events(
    events: List[Tuple[float, int, int, int]],
    sample_rate: int = 48000,
    tail: float = 1.0,
) -> np.ndarray:
    """Note events -> float32 mono [-1, 1].  Additive synth: 3 harmonics
    with exponential decay from note-on to note-off (+ release)."""
    if not events:
        return np.zeros(sample_rate, np.float32)
    # pair note-ons with their offs
    notes = []  # (t_on, t_off, midi_note, velocity)
    active = {}
    end = 0.0
    for t, ch, note, vel in events:
        if ch == 9:  # percussion channel: skip (no drum kit)
            continue
        key = (ch, note)
        if vel > 0:
            active[key] = (t, vel)
        elif key in active:
            t_on, v = active.pop(key)
            notes.append((t_on, t, note, v))
            end = max(end, t)
    for (ch, note), (t_on, v) in active.items():  # unterminated notes
        notes.append((t_on, t_on + 1.0, note, v))
        end = max(end, t_on + 1.0)
    n = int((end + tail) * sample_rate) + 1
    out = np.zeros(n, np.float32)
    for t_on, t_off, note, vel in notes:
        f = 440.0 * 2 ** ((note - 69) / 12)
        dur = min(t_off - t_on + 0.3, 8.0)  # 0.3 s release
        ns = int(dur * sample_rate)
        tt = np.arange(ns, dtype=np.float32) / sample_rate
        env = np.exp(-3.0 * tt, dtype=np.float32)
        env[: min(64, ns)] *= np.linspace(0, 1, min(64, ns), dtype=np.float32)
        gate = int((t_off - t_on) * sample_rate)
        if gate < ns:  # faster decay after note-off
            env[gate:] *= np.exp(-20.0 * np.arange(ns - gate) / sample_rate).astype(np.float32)
        w = (
            np.sin(2 * np.pi * f * tt)
            + 0.35 * np.sin(4 * np.pi * f * tt)
            + 0.15 * np.sin(6 * np.pi * f * tt)
        )
        s0 = int(t_on * sample_rate)
        seg = (w * env * (vel / 127.0) * 0.2).astype(np.float32)
        out[s0 : s0 + ns] += seg[: max(0, n - s0)]
    peak = float(np.max(np.abs(out)))
    if peak > 1.0:
        out /= peak * 1.05
    return out


class FluidSynthCapture(AudioCapture):
    """``fluidsynth[:file=<filename>|song=<idx>][:loop=<iter>]``
    (ref grammar: src/audio/capture/fluidsynth.c usage())."""

    def __init__(self, cfg: str = ""):
        super().__init__(cfg)
        path = None
        loop = 0  # 0 = loop forever (reference loops its songs too)
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "file":
                path = val
            elif key == "song":
                if int(val) != 1:
                    log.warning("only bundled song 1 exists; using it")
            elif key == "loop":
                loop = int(val)
            elif key == "help":
                print("fluidsynth[:file=<filename>|song=<idx>][:loop=<iter>]")
        data = open(path, "rb").read() if path else _bundled_song()
        events = parse_smf(data)
        self.desc = AudioDesc(bps=2, sample_rate=48000, ch_count=2, codec="PCM")
        mono = render_events(events, self.desc.sample_rate)
        self.pcm = mono
        self.loop = loop
        self.pos = 0
        self.iterations = 0
        log.notice(
            f"synthesized {len(events)} MIDI events -> "
            f"{len(mono)/self.desc.sample_rate:.1f} s of audio"
        )

    def read(self, nsamples: int) -> Optional[AudioFrame]:
        out = np.empty(nsamples, np.float32)
        filled = 0
        while filled < nsamples:
            avail = len(self.pcm) - self.pos
            if avail == 0:
                self.iterations += 1
                if self.loop and self.iterations >= self.loop:
                    if filled == 0:
                        return None
                    out[filled:] = 0.0
                    break
                self.pos = 0
                avail = len(self.pcm)
            take = min(avail, nsamples - filled)
            out[filled : filled + take] = self.pcm[self.pos : self.pos + take]
            self.pos += take
            filled += take
        samples = np.tile(out, (self.desc.ch_count, 1))
        frame = AudioFrame.from_float(self.desc, samples)
        frame.timestamp = time.monotonic()
        return frame


register_module("fluidsynth", LibraryClass.AUDIO_CAPTURE, FluidSynthCapture)
register_module("midi", LibraryClass.AUDIO_CAPTURE, FluidSynthCapture)
