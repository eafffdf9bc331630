"""Panorama stitcher capture: N cameras -> one equirectangular frame.

Port of ``ultragrid_tpu/modules/stitch.py``, the counterpart of the
reference's ``gpustitch`` capture module (ref: src/video_capture/
gpustitch.cpp — a CUDA SDK that composites multiple camera inputs into a
360° panorama).  Per camera an inverse-projection gather map and a feathered
weight mask are computed once on the host (float64, as the JAX package
computes them); per frame the cameras are gathered and blended as a
weighted sum on the capture's device.

The blend rounds as XLA's CPU compile of the reference's jitted blend: the
first two products summed as one fused multiply-add (the first product
fused), each further product fused into the running sum, and the division
by the constant weight sum taken as a product with its float32 reciprocal.

Grammar: ``stitch:dev1#dev2[#...][;size=WxH][;fov=<deg>]``
(child capture specs use ``#`` separators and ``;`` for stitcher options so
the children keep their own ``:`` grammar).  Camera *i* is assumed to look
at yaw ``i * 360/N`` with the given horizontal FOV (the reference's rig
configs hardcode per-camera extrinsics the same way).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_capture import VideoCapture, initialize_video_capture
from ultragrid_tpu_torch.ops.pixfmt import convert_frame
from ultragrid_tpu_torch.types import Codec, InterlacingType, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("stitch")


class StitchCapture(VideoCapture):
    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        ow, oh = 1024, 512
        fov = None
        main, _, opts = cfg.partition(";")
        for tok in [t for t in opts.split(";") if t]:
            key, _, val = tok.partition("=")
            if key == "size":
                w, _, h = val.partition("x")
                ow, oh = int(w), int(h)
            elif key == "fov":
                fov = float(val)
        specs = [s for s in main.split("#") if s]
        if not specs:
            raise ValueError("stitch: needs at least one child capture")
        self.children = [initialize_video_capture(s, device=self.device) for s in specs]
        n = len(self.children)
        if fov is None:
            # default: enough overlap to feather (1.4x the sector width)
            fov = min(140.0, 1.4 * 360.0 / n) if n > 1 else 120.0
        self.fov = fov
        self.ow, self.oh = ow, oh
        d0 = self.children[0].desc
        self.desc = VideoDesc(ow, oh, Codec.RGB, d0.fps, InterlacingType.PROGRESSIVE, 1)
        # per camera (sy, sx, weight [oh, ow, 1]) on the device, and the
        # reciprocal of the weight sum [oh, ow, 1]
        self._maps: Optional[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]] = None
        self._recip: Optional[torch.Tensor] = None
        self._cam_wh: Optional[Tuple[int, int]] = None
        log.notice(f"stitching {n} cameras @ {fov:.0f}° hfov -> {ow}x{oh} equirect")

    def _build(self, cw: int, ch: int) -> None:
        n = len(self.children)
        ow, oh = self.ow, self.oh
        lon = (np.arange(ow) + 0.5) / ow * 2 * np.pi - np.pi
        lat = (np.arange(oh) + 0.5) / oh * np.pi - np.pi / 2
        lon, lat = np.meshgrid(lon, lat)
        dx = np.cos(lat) * np.sin(lon)
        dy = np.sin(lat)
        dz = np.cos(lat) * np.cos(lon)
        f = 0.5 * cw / np.tan(np.radians(self.fov) / 2)
        maps = []
        wsum = np.zeros((oh, ow), np.float32)
        for i in range(n):
            yaw = np.radians(i * 360.0 / n)
            cy, sy = np.cos(yaw), np.sin(yaw)
            # rotate world dir into camera i's frame (inverse yaw)
            cdx = dx * cy - dz * sy
            cdz = dx * sy + dz * cy
            cdy = dy
            with np.errstate(divide="ignore", invalid="ignore"):
                u = cdx / cdz * f + cw / 2
                v = cdy / cdz * f + ch / 2
            valid = (cdz > 1e-6) & (u >= 0) & (u < cw) & (v >= 0) & (v < ch)
            # feather: weight by distance to the nearest frame edge
            wu = np.minimum(u, cw - 1 - u) / (cw / 2)
            wv = np.minimum(v, ch - 1 - v) / (ch / 2)
            w = np.where(valid, np.clip(np.minimum(wu, wv), 1e-4, 1.0), 0.0).astype(np.float32)
            sx = np.clip(np.nan_to_num(u), 0, cw - 1).astype(np.int64)
            sy_ = np.clip(np.nan_to_num(v), 0, ch - 1).astype(np.int64)
            maps.append((sy_, sx, w))
            wsum = wsum + w  # float32, camera by camera, as XLA folds the constant sum
        if (wsum == 0).any():
            log.warning(
                f"stitch: {(wsum == 0).mean() * 100:.1f}% of the panorama is "
                "uncovered (increase fov= or add cameras); filling black"
            )
        recip = np.float32(1.0) / np.maximum(wsum, np.float32(1e-6))
        dev = self.device
        self._maps = [(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
                       torch.as_tensor(w[:, :, None], device=dev)) for a, b, w in maps]
        self._recip = torch.as_tensor(recip[:, :, None], device=dev)
        self._cam_wh = (cw, ch)

    def blend(self, rgbs: List[torch.Tensor]) -> torch.Tensor:
        """Cameras' uint8 [ch, cw, 3] -> the panorama, uint8 [oh, ow * 3]."""
        samples = [(rgb[sy, sx, :].to(torch.float32), w) for (sy, sx, w), rgb in zip(self._maps, rgbs)]
        (s0, w0), rest = samples[0], samples[1:]
        if rest:
            s1, w1 = rest.pop(0)
            acc = torch.addcmul(s1 * w1, s0, w0)
        else:
            acc = s0 * w0
        for s, w in rest:
            acc = torch.addcmul(acc, s, w)
        out = torch.clamp(torch.round(acc * self._recip), 0, 255).to(torch.uint8)
        return out.reshape(self.oh, self.ow * 3)

    def grab(self):
        rgbs = []
        ts = None
        for c in self.children:
            frame, _a = c.grab()
            if frame is None:
                return None, None
            ts = frame.timestamp if ts is None else ts
            d = frame.desc
            tile = frame.data
            rgb = tile if d.color_spec == Codec.RGB else convert_frame(tile, d.width, d.color_spec, Codec.RGB)
            rgbs.append(rgb[:, : d.width * 3].reshape(d.height, d.width, 3))
        cw, ch = rgbs[0].shape[1], rgbs[0].shape[0]
        if self._maps is None or self._cam_wh != (cw, ch):
            self._build(cw, ch)
        return VideoFrame(self.desc, [self.blend(rgbs)], timestamp=ts), None

    def done(self) -> None:
        for c in self.children:
            c.done()


register_module("stitch", LibraryClass.VIDEO_CAPTURE, StitchCapture)
register_module("gpustitch", LibraryClass.VIDEO_CAPTURE, StitchCapture)
