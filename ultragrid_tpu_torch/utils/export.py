"""Session export (record) and import (replay) — the checkpoint/resume analogue.

File-format compatible with the reference (ref: src/video_export.c:159-245,
src/export.c): a directory with ``video.info`` (version/width/height/fourcc/
fps/interlacing/count), frames as ``%08d.<ext>`` starting at 1, and
``sound.wav`` for audio.  Recorded sessions from the reference can be replayed
here and vice versa.

The port's copy of ``ultragrid_tpu/utils/export.py``.  The exporter copies a
frame that lives on the card to the host once, to write it; the import
capture uploads each recorded frame to its device (the card unless the
caller names another, raising without one), as the testcard's ring lives
there.  A compressed recording's bitstream stays on the host, where the
port's decompressors and packetizer read compressed frames.
"""

from __future__ import annotations

import os
import struct
import time
import wave
from typing import Optional

import numpy as np
import torch

from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
from ultragrid_tpu_torch.device import host_bytes
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_capture import VideoCapture
from ultragrid_tpu_torch.types import (
    Codec,
    InterlacingType,
    VideoDesc,
    VideoFrame,
    get_codec_from_fourcc,
    get_codec_info,
    codec_is_planar,
    get_fourcc,
    is_codec_opaque,
    vc_get_linesize,
)
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("export")

VIDEO_EXPORT_SUMMARY_VERSION = 1


class Exporter:
    """-E/--record: write video frames + sound.wav (ref: src/export.c:150)."""

    def __init__(self, directory: Optional[str] = None):
        if directory is None:
            directory = time.strftime("export.%Y%m%d.%H%M%S")  # dir_auto
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)
        self.count = 0
        self.desc: Optional[VideoDesc] = None
        self._wav = None

    def export_video(self, frame: VideoFrame) -> None:
        if self.desc is None:
            self.desc = frame.desc
        elif self.desc.with_(fps=frame.desc.fps) != frame.desc.with_(fps=frame.desc.fps):
            log.warning("format change detected, not exporting")
            return
        self.count += 1
        ext = get_codec_info(frame.desc.color_spec).file_extension or "raw"
        path = os.path.join(self.dir, f"{self.count:08d}.{ext}")
        host_bytes(frame.data).tofile(path)  # the one copy of a frame on the card

    def export_audio(self, frame: AudioFrame) -> None:
        if self._wav is None:
            self._wav = wave.open(os.path.join(self.dir, "sound.wav"), "wb")
            self._wav.setnchannels(frame.desc.ch_count)
            self._wav.setsampwidth(frame.desc.bps)
            self._wav.setframerate(frame.desc.sample_rate)
        self._wav.writeframes(frame.to_interleaved().tobytes())

    def finish(self) -> None:
        if self.desc is not None:
            fourcc = get_fourcc(self.desc.color_spec)
            with open(os.path.join(self.dir, "video.info"), "w") as f:
                f.write(f"version {VIDEO_EXPORT_SUMMARY_VERSION}\n")
                f.write(f"width {self.desc.width}\n")
                f.write(f"height {self.desc.height}\n")
                f.write(f"fourcc {struct.pack('<I', fourcc).decode('latin1')}\n")
                f.write(f"fps {self.desc.fps:.2f}\n")
                f.write(f"interlacing {int(self.desc.interlacing)}\n")
                f.write(f"count {self.count}\n")
        if self._wav is not None:
            self._wav.close()


def read_video_info(directory: str) -> dict:
    info = {}
    with open(os.path.join(directory, "video.info")) as f:
        for line in f:
            key, _, val = line.strip().partition(" ")
            info[key] = val
    return info


class ImportCapture(VideoCapture):
    """-I/--playback: replay a recorded session as a capture device
    (ref: src/video_capture/import.c:164-204; VCR messages via the module
    message bus map to the loop/pause options here)."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        opts = cfg.split(":")
        self.dir = opts[0]
        self.loop = "loop" in opts[1:]
        info = read_video_info(self.dir)
        fourcc = struct.unpack("<I", info["fourcc"].encode("latin1")[:4])[0]
        codec = get_codec_from_fourcc(fourcc)
        self.desc = VideoDesc(
            int(info["width"]),
            int(info["height"]),
            codec,
            float(info["fps"]),
            InterlacingType(int(info.get("interlacing", 0))),
        )
        self.frame_count = int(info["count"])
        self.ext = get_codec_info(codec).file_extension or "raw"
        self.index = 0
        self.start_time: Optional[float] = None
        # audio, if present
        self.audio_pos = 0
        wav_path = os.path.join(self.dir, "sound.wav")
        self._wav = wave.open(wav_path, "rb") if os.path.exists(wav_path) else None

    def grab(self):
        if self.index >= self.frame_count:
            if not self.loop:
                # the end of the recording ends the session, as the C import
                # capture's exit_uv does (ROADMAP F9)
                self.finished = True
                return None, None
            self.index = 0
        now = time.monotonic()
        if self.start_time is None:
            self.start_time = now
        deadline = self.start_time + self.index / self.desc.fps
        if now < deadline:
            time.sleep(deadline - now)
        frame = self.frame_at(self.index)
        frame.timestamp = now
        audio = None
        if self._wav is not None:
            n = int(self._wav.getframerate() / self.desc.fps)
            raw = self._wav.readframes(n)
            if raw:
                adesc = AudioDesc(
                    bps=self._wav.getsampwidth(),
                    sample_rate=self._wav.getframerate(),
                    ch_count=self._wav.getnchannels(),
                )
                audio = AudioFrame.from_interleaved(adesc, np.frombuffer(raw, np.uint8))
        self.index += 1
        return frame, audio

    def read_host(self, index: int) -> np.ndarray:
        """The recorded bytes of frame ``index`` (from 0), as the reference
        shapes them: [height, linesize] for a packed pixel format."""
        path = os.path.join(self.dir, f"{index + 1:08d}.{self.ext}")
        data = np.fromfile(path, dtype=np.uint8)
        if not (is_codec_opaque(self.desc.color_spec) or codec_is_planar(self.desc.color_spec)):
            ls = vc_get_linesize(self.desc.width, self.desc.color_spec)
            data = data[: self.desc.height * ls].reshape(self.desc.height, ls)
        return data

    def frame_at(self, index: int) -> VideoFrame:
        """Frame ``index``: pixels uploaded to the capture's device, a
        compressed bitstream kept on the host."""
        data = self.read_host(index)
        if not is_codec_opaque(self.desc.color_spec):
            data = torch.from_numpy(data).to(self.device)
        return VideoFrame(self.desc, [data])

    def done(self) -> None:
        if self._wav is not None:
            self._wav.close()


register_module("import", LibraryClass.VIDEO_CAPTURE, ImportCapture)
