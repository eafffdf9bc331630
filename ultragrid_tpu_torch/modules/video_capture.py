"""Video capture module API + built-in devices on tensors.

Port of ``ultragrid_tpu/modules/video_capture.py``.  Mirrors the reference's
vidcap contract (ref: struct video_capture_info, src/video_capture.h:121-145):
``init(cfg) -> state``, ``grab() -> (VideoFrame | None, AudioFrame | None)``,
``done()``.  Config strings use the reference's colon/key=value grammar
(``testcard:1920:1080:24:UYVY`` or ``testcard:s=1920x1080:f=60:c=UYVY:pattern=bars``).
Each device captures to ``device``, the card unless the caller names
another; it raises there without one.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device
from ultragrid_tpu_torch.modules.registry import LibraryClass, load_library, register_module
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.types import Codec, InterlacingType, VideoDesc, VideoFrame, get_codec_from_name
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.pattern import generate_pattern

log = Logger("vidcap")

VIDCAP_INIT_OK = 0
VIDCAP_INIT_FAIL = 1
VIDCAP_INIT_NOERR = 2  # help shown


def _pace(cap) -> None:
    """Sleep until the next frame slot at ``cap.desc.fps``.

    Paces relative to the PREVIOUS slot, never the session start: when a
    grab arrives late (downstream stall, session warmup) the schedule
    resets to *now* instead of replaying the missed slots in a burst —
    exactly the reference testcard's behaviour, which waits 1/fps from
    the previous grab (ref: testcard.c:762-776).  Catch-up bursts would
    keep every pipeline queue full and turn a transient stall into
    permanent end-to-end latency.
    """
    now = time.monotonic()
    period = 1.0 / cap.desc.fps
    prev = getattr(cap, "_pace_deadline", None)
    if prev is None:
        if cap.start_time is None:
            cap.start_time = now
        deadline = now
    else:
        deadline = prev + period
        if now >= deadline:
            deadline = now  # behind schedule: drop missed slots
        else:
            time.sleep(deadline - now)
    cap._pace_deadline = deadline


class VideoCapture:
    """Base class for capture devices.  ``finished`` turns true when a
    device has nothing more to give (a replayed recording at its end), and
    the sender then stops."""

    finished = False

    def __init__(self, cfg: str, device="cuda"):
        self.cfg = cfg
        self.device = get_device(device)

    def grab(self) -> Tuple[Optional[VideoFrame], Optional[object]]:
        raise NotImplementedError

    def done(self) -> None:
        pass


def _parse_testcard(cfg: str):
    """(desc, pattern, still) of a testcard config string."""
    width, height, fps, codec = 1920, 1080, 24.0, Codec.UYVY
    pattern = "bars"
    still = False
    positional = []
    for tok in [t for t in cfg.split(":") if t]:
        if "=" in tok:
            key, _, val = tok.partition("=")
            if key in ("s", "size"):
                w, _, h = val.partition("x")
                width, height = int(w), int(h)
            elif key in ("f", "fps"):
                fps = float(val.rstrip("ip"))
            elif key in ("c", "codec"):
                codec = get_codec_from_name(val)
            elif key in ("p", "pattern"):
                pattern = val
            elif key == "still":
                still = True
            else:
                log.warning(f"testcard: unknown option {key}")
        else:
            positional.append(tok)
    # legacy positional grammar: width:height:fps:codec
    if len(positional) >= 2 and positional[0].isdigit():
        width, height = int(positional[0]), int(positional[1])
        if len(positional) >= 3:
            fps = float(positional[2])
        if len(positional) >= 4:
            codec = get_codec_from_name(positional[3])
    if codec == Codec.NONE:
        raise ValueError("testcard: unknown codec")
    return VideoDesc(width, height, codec, fps, InterlacingType.PROGRESSIVE, 1), pattern, still


class TestcardCapture(VideoCapture):
    """Synthetic pattern generator (ref: src/video_capture/testcard.c).

    Defaults mirror the reference: 1920x1080 UYVY 24 fps "bars"
    (ref: DEFAULT_FORMAT, testcard.c:101-102).  The pre-rolled ring of
    frames lives on ``device`` (the reference's prerendered testcard ring,
    device-resident as in the JAX package): a grab hands out a tensor there
    and copies nothing.
    """

    __test__ = False  # not a pytest class

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.desc, pattern, self.still = _parse_testcard(cfg)
        d = self.desc
        base = generate_pattern(d.width, d.height, d.color_spec, pattern, device=self.device)
        # pre-roll a few phase-shifted variants so motion is visible
        shifts = [0] if self.still else [i * 16 for i in range(8)]
        self.frames = [torch.roll(base, shifts=s, dims=0) for s in shifts]
        self.count = 0
        self.start_time: Optional[float] = None
        log.notice(f"capturing {self.desc}, pattern {pattern}")

    def grab(self):
        _pace(self)
        frame = VideoFrame(self.desc, [self.frames[self.count % len(self.frames)]])
        frame.timestamp = time.monotonic()
        self.count += 1
        return frame, None


class NoiseCapture(VideoCapture):
    """Random-noise source for stress/benchmarks (testcard pattern=noise at
    frame rate, pre-generated ring to avoid host bottleneck)."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.inner = TestcardCapture(cfg + ":pattern=noise" if "pattern" not in cfg else cfg, device)
        self.desc = self.inner.desc

    def grab(self):
        return self.inner.grab()


class Testcard2Capture(VideoCapture):
    """Animated test source (ref: src/video_capture/testcard2.c): bars
    background + two bouncing squares (300x300 cyan-ish and 96x96, stepping
    6/12 px per frame like testcard2.c:568-600) + a timestamp/frame-number
    banner.  Composition happens in RGBA on the host (tiny), then ONE
    conversion on the capture's device produces the requested codec.  The
    squares start where ``rng`` puts them (a seeded generator by default).

    Grammar: same as testcard (``testcard2:1920:1080:30:UYVY`` or key=val).
    """

    def __init__(self, cfg: str, device="cuda", rng: Optional[np.random.Generator] = None):
        super().__init__(cfg, device)
        self.desc, _, _ = _parse_testcard(cfg)
        w, h = self.desc.width, self.desc.height
        self.bg = generate_pattern(w, h, Codec.RGBA, "bars", device="cpu").numpy().reshape(h, w, 4).copy()
        rng = rng if rng is not None else np.random.default_rng(0)
        s1 = max(6, min(300, w // 3, h // 3))  # clamp for small frames
        s2 = max(4, min(96, w // 6, h // 6))
        self.sq = [  # [x, y, dx, dy, w, h, color]
            [int(rng.integers(0, max(w - s1, 1))), int(rng.integers(0, max(h - s1, 1))),
             6, 6, s1, s1, (0xAA, 0x00, 0xFF, 0xFF)],
            [int(rng.integers(0, max(w - s2, 1))), int(rng.integers(0, max(h - s2, 1))),
             12, 9, s2, s2, (0xFF, 0xFF, 0x00, 0xFF)],
        ]
        self.count = 0
        self.start_time: Optional[float] = None
        log.notice(f"capturing {self.desc} (testcard2 animated)")

    def _banner(self, img: np.ndarray) -> None:
        elapsed = self.count / self.desc.fps
        text = f"{int(elapsed // 60):02d}:{int(elapsed) % 60:02d}.{int(elapsed * 100) % 100:02d} {self.count}"
        try:
            from PIL import Image, ImageDraw
        except ImportError:  # no font renderer: no banner, as in the JAX package
            return
        im = Image.new("L", (len(text) * 8 + 4, 14))
        ImageDraw.Draw(im).text((2, 1), text, fill=255)
        mask = np.asarray(im) > 127
        mask = np.repeat(np.repeat(mask, 2, axis=0), 2, axis=1)
        mh, mw = mask.shape
        y0 = img.shape[0] - mh - 8
        x0 = 8
        if y0 < 0 or x0 + mw > img.shape[1]:
            return
        region = img[y0 : y0 + mh, x0 : x0 + mw]
        region[:] = region // 3  # dim box
        region[mask] = (255, 255, 255, 255)

    def grab(self):
        _pace(self)
        img = self.bg.copy()
        h, w = img.shape[:2]
        for s in self.sq:
            s[0] += s[2]
            s[1] += s[3]
            if s[0] < 0:
                s[0], s[2] = 0, abs(s[2])
            if s[1] < 0:
                s[1], s[3] = 0, abs(s[3])
            if s[0] + s[4] > w:
                s[0], s[2] = w - s[4], -abs(s[2])
            if s[1] + s[5] > h:
                s[1], s[3] = h - s[5], -abs(s[3])
            img[s[1] : s[1] + s[5], s[0] : s[0] + s[4]] = s[6]
        self._banner(img)
        data = torch.as_tensor(img.reshape(h, w * 4)).to(self.device)
        if self.desc.color_spec != Codec.RGBA:
            data = pixfmt.convert_frame(data, w, Codec.RGBA, self.desc.color_spec)
        frame = VideoFrame(self.desc, [data])
        frame.timestamp = time.monotonic()
        self.count += 1
        return frame, None


register_module("testcard", LibraryClass.VIDEO_CAPTURE, TestcardCapture)
register_module("testcard2", LibraryClass.VIDEO_CAPTURE, Testcard2Capture)
register_module("noise", LibraryClass.VIDEO_CAPTURE, NoiseCapture)


def initialize_video_capture(spec: str, device="cuda") -> VideoCapture:
    """ref: initialize_video_capture, src/video_capture.c; the device
    captures to ``device``, the card unless the caller names another."""
    name, _, cfg = spec.partition(":")
    cls = load_library(name, LibraryClass.VIDEO_CAPTURE)
    if cls is None:
        raise ValueError(f"unknown capture device {name!r}")
    return cls(cfg, device=device)
