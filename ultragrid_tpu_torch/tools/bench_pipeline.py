"""Benchmark suite: the five BASELINE.md configurations, on the card.

The port of ``ultragrid_tpu/tools/bench_pipeline.py``:

  1. testcard 1080p UYVY->RGB conversion
  2. v210 / R10k 10-bit unpack + color conversion at 4K
  3. DXT1 / DXT5-YCoCg of RGB 1080p
  4. JPEG encode 4:2:2 4K (device half, kernel K1), the full path with the
     host C assembly pipelined behind it, and 4:2:0
  5. 8K UYVY -> JPEG -> LDGM full pipeline (K1 + host C assembly + host C
     LDGM), and its device half

Prints one JSON line per configuration with the reference's ``config``
strings and keys (``config``, ``ms_per_frame``, ``fps``).  A row's time is
the host clock around back-to-back frames closed by ``torch.cuda.synchronize``
(the reference fetched one scalar of the last output instead: a workaround
for its RPC tunnel, not ported).  The row builders take the sizes and the
device, so the same rows run small on the CPU.

Usage: python -m ultragrid_tpu_torch.tools.bench_pipeline [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.ops.dxt import dxt1_encode_rgb, dxt5_ycocg_encode_rgb
from ultragrid_tpu_torch.ops.fec import LdgmSession
from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
from ultragrid_tpu_torch.tools._bench import device_arg, sync
from ultragrid_tpu_torch.types import Codec, vc_get_linesize

# the reference's frame sizes (ref bench_pipeline.py:59-111)
SIZES = {"1080p": (1920, 1080), "4K": (3840, 2160), "8K": (7680, 4320)}
CONFIGS = (
    "1080p UYVY->RGB convert",
    "4K v210->RG48 convert",
    "4K R10k->Y416 convert",
    "1080p DXT1 encode",
    "1080p DXT5-YCoCg encode",
    "4K UYVY->JPEG device encode",
    "4K UYVY->JPEG full path (device+assembly, pipelined)",
    "4K UYVY->JPEG 4:2:0 device encode",
    "8K UYVY->JPEG->LDGM full pipeline (e2e incl host)",
    "8K UYVY->JPEG device encode",
)


@dataclasses.dataclass
class Row:
    """One configuration: ``measure()`` -> (seconds a frame, the last call's
    output); ``plain()``, where the row runs a hand kernel, gives the same
    output through its plain versions."""

    config: str
    frame: torch.Tensor
    measure: Callable[[], Tuple[float, object]]
    plain: Optional[Callable[[], object]] = None
    seconds: float = 0.0
    last: object = None

    def run(self) -> dict:
        self.seconds, self.last = self.measure()
        return report(self.config, self.seconds)


def report(name: str, seconds: float) -> dict:
    row = {"config": name, "ms_per_frame": round(seconds * 1000, 3), "fps": round(1.0 / seconds, 1)}
    print(json.dumps(row), flush=True)
    return row


def timed(fn, device: torch.device, n: int = 20, warm: int = 2):
    """(seconds a call over ``n`` back-to-back calls after ``warm``, the
    last output): the host clock, closed by a synchronise."""
    for _ in range(warm):
        r = fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        r = fn()
    sync(device)
    return (time.perf_counter() - t0) / n, r


def content(w: int, h: int, rng) -> np.ndarray:
    """A UYVY frame: a horizontal gradient with noise, limited range."""
    return (np.linspace(0, 255, w * 2, dtype=np.float32)[None, :]
            + rng.normal(0, 8, (h, w * 2))).clip(16, 235).astype(np.uint8)


def noise(h: int, linesize: int, rng) -> np.ndarray:
    return rng.integers(0, 255, (h, linesize), np.int32).astype(np.uint8)


def conversion_rows(size1080, size4k, device, rng) -> List[Row]:
    """Rows 1-2: UYVY->RGB at the first size, v210->RG48 and R10k->Y416 at
    the second."""
    rows = []
    for (w, h), a, b, config in ((size1080, Codec.UYVY, Codec.RGB, CONFIGS[0]),
                                 (size4k, Codec.v210, Codec.RG48, CONFIGS[1]),
                                 (size4k, Codec.R10k, Codec.Y416, CONFIGS[2])):
        f = torch.from_numpy(noise(h, vc_get_linesize(w, a), rng)).to(device)
        rows.append(Row(config, f, lambda f=f, w=w, a=a, b=b: timed(
            lambda: pixfmt.convert_frame(f, w, a, b), device)))
    return rows


def dxt_rows(size1080, device, rng) -> List[Row]:
    """Row 3: DXT1 and DXT5-YCoCg of an RGB frame."""
    w, h = size1080
    rgb = torch.from_numpy(noise(h, w * 3, rng)).to(device)
    return [Row(CONFIGS[3], rgb, lambda: timed(lambda: dxt1_encode_rgb(rgb, w), device)),
            Row(CONFIGS[4], rgb, lambda: timed(lambda: dxt5_ycocg_encode_rgb(rgb, w), device))]


class HostStage:
    """A frame's parts copied to pinned host buffers without blocking, and
    waited for through an event recorded after the copies: waiting for
    frame i never waits for frame i + 1, queued behind it (a plain ``.cpu()``
    would).  On the CPU the parts are the host arrays already."""

    def __init__(self, device: torch.device):
        self.device = device
        self.bufs = None
        self.event = None

    def fetch(self, parts) -> None:
        if self.device.type != "cuda":
            self.bufs = list(parts)
            return
        if self.bufs is None or [b.shape for b in self.bufs] != [p.shape for p in parts]:
            self.bufs = [torch.empty(p.shape, dtype=p.dtype, pin_memory=True) for p in parts]
        for b, p in zip(self.bufs, parts):
            b.copy_(p, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [b.numpy() for b in self.bufs]


def pipelined_full_path(enc: JpegEncoder, frame: torch.Tensor, n: int = 12):
    """Row 4b (ref bench_pipeline.py:79-91): frame i + 1's device encode is
    queued before frame i's parts are assembled on the host, so the two
    halves overlap as in the sender's compress worker.  Returns (seconds a
    frame over n + 1 frames, the last JPEG body)."""
    stage = HostStage(frame.device)
    stage.fetch(enc.encode_device(frame)[:-1])
    t0 = time.perf_counter()
    for _ in range(n):
        nxt = enc.encode_device(frame)  # queued behind frame i's copies
        enc.assemble(*stage.wait())     # the host half of frame i
        stage.fetch(nxt[:-1])
    body = enc.assemble(*stage.wait())
    return (time.perf_counter() - t0) / (n + 1), body


def jpeg_rows(size4k, device, rng) -> List[Row]:
    """Rows 4, 4b, 4c: the JPEG q80 device half (K1) at 4:2:2, the full path
    with the host assembly pipelined, and 4:2:0."""
    w, h = size4k
    f = torch.from_numpy(content(w, h, rng)).to(device)
    enc = JpegEncoder(w, h, in_codec=Codec.UYVY, quality=80)
    enc420 = JpegEncoder(w, h, in_codec=Codec.UYVY, quality=80, subsampling="420")
    return [
        Row(CONFIGS[5], f, lambda: timed(lambda: enc.encode_device(f), device),
            lambda: enc.encode_plain(f)),
        Row(CONFIGS[6], f, lambda: pipelined_full_path(enc, f),
            lambda: enc.assemble(*enc.encode_plain(f)[:-1])),
        Row(CONFIGS[7], f, lambda: timed(lambda: enc420.encode_device(f), device),
            lambda: enc420.encode_plain(f)),
    ]


def ldgm_buffer(enc: JpegEncoder, parts, ldgm: LdgmSession) -> np.ndarray:
    """The host half of row 5: C assembly, then the C LDGM encode."""
    buf, _ = ldgm.encode(enc.assemble(*parts[:-1]))
    return buf


def e2e_rows(size8k, device, rng) -> List[Row]:
    """Row 5: 8K UYVY -> JPEG (K1) -> host C assembly -> host C LDGM
    (1500, 250, 5) end to end, and its device half."""
    w, h = size8k
    f = torch.from_numpy(content(w, h, rng)).to(device)
    enc = JpegEncoder(w, h, in_codec=Codec.UYVY, quality=80)
    ldgm = LdgmSession(1500, 250, 5)

    def full():
        return ldgm_buffer(enc, enc.encode_device(f), ldgm)

    return [Row(CONFIGS[8], f, lambda: timed(full, device, n=5, warm=1),
                lambda: ldgm_buffer(enc, enc.encode_plain(f), ldgm)),
            Row(CONFIGS[9], f, lambda: timed(lambda: enc.encode_device(f), device, n=10),
                lambda: enc.encode_plain(f))]


def build_rows(device: torch.device, sizes=SIZES, seed: int = 0) -> List[Row]:
    """The ten rows in the reference's order, its frames drawn in its order."""
    rng = np.random.default_rng(seed)
    return (conversion_rows(sizes["1080p"], sizes["4K"], device, rng) + dxt_rows(sizes["1080p"], device, rng)
            + jpeg_rows(sizes["4K"], device, rng) + e2e_rows(sizes["8K"], device, rng))


def run(device: torch.device, sizes=SIZES) -> List[Row]:
    """Build and run the ten rows, one JSON line each; returns them with
    their times and last outputs."""
    rows = build_rows(device, sizes)
    for row in rows:
        row.run()
    return rows


def main(argv=None) -> int:
    _, device = device_arg(sys.argv[1:] if argv is None else argv)
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
