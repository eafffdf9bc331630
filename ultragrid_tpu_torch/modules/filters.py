"""Capture filters & display postprocess modules on tensors.

Port of ``ultragrid_tpu/modules/filters.py``.  One implementation serves
both roles where meaningful, mirroring the reference's
capture_filter_wrapper.h (ref: src/capture_filter/ ABI 4,
src/vo_postprocess/ ABI 8).  A filter transforms a VideoFrame whose tiles are
uint8 tensors and keeps them on the device they came on; chains are
comma-separated specs like the reference's --capture-filter grammar.  Every
name of the JAX package's ``_FILTERS`` is here, registered in the port's
registry as capture filter and as postprocess.

Where the JAX package fetches a frame to the host (``border``, ``text``,
``interlaced_3d``), the port works on the frame's tensors and gives the same
bytes.  ``noise`` draws from one ``torch.Generator`` per filter (seeded,
never the global one): ``jax.random`` cannot be reproduced, so its contract
is values within ``±amount`` of the input, clipped to 0..255, and the same
noise for the same seed on one device.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.ops import postprocess as pp
from ultragrid_tpu_torch.types import (Codec, InterlacingType, VideoDesc, VideoFrame, get_codec_from_name,
                                       vc_get_linesize)
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.tiling import vf_split

log = Logger("filter")


class Filter:
    def __init__(self, cfg: str):
        self.cfg = cfg

    def apply(self, frame: VideoFrame) -> Optional[VideoFrame]:
        raise NotImplementedError

    def _wrap(self, frame: VideoFrame, data, desc: Optional[VideoDesc] = None) -> VideoFrame:
        out = VideoFrame(desc or frame.desc, [data])
        out.timestamp = frame.timestamp
        return out


class ScaleFilter(Filter):
    """scale:WxH | scale:W:H (ref: vo_postprocess/scale.c)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        if "x" in cfg:
            w, _, h = cfg.partition("x")
        else:
            w, _, h = cfg.partition(":")
        self.w, self.h = int(w), int(h)

    def apply(self, frame):
        d = frame.desc
        data = pp.scale_nearest(frame.data, d.width, d.color_spec, self.w, self.h)
        return self._wrap(frame, data, d.with_(width=self.w, height=self.h))


class DeinterlaceFilter(Filter):
    """deinterlace[:blend|linear|bob] (ref: vo_postprocess/deinterlace.c)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.mode = cfg or "blend"

    def apply(self, frame):
        d = frame.desc
        if self.mode == "blend":
            data = pp.deinterlace_blend(frame.data, d.color_spec)
        elif self.mode == "linear":
            data = pp.deinterlace_linear(frame.data, d.color_spec)
        elif self.mode == "bob":
            data = pp.deinterlace_bob_even(frame.data)
        else:
            raise ValueError(f"deinterlace: unknown mode {self.mode}")
        return self._wrap(frame, data, d.with_(interlacing=InterlacingType.PROGRESSIVE))


class InterlaceFilter(Filter):
    def apply(self, frame):
        data = pp.interlace(frame.data)
        return self._wrap(frame, data, frame.desc.with_(interlacing=InterlacingType.INTERLACED_MERGED))


class CropFilter(Filter):
    """crop:W:H[:x:y] (ref: vo_postprocess crop)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        parts = [int(p) for p in cfg.split(":") if p]
        self.w, self.h = parts[0], parts[1]
        self.x = parts[2] if len(parts) > 2 else 0
        self.y = parts[3] if len(parts) > 3 else 0

    def apply(self, frame):
        d = frame.desc
        data = pp.crop(frame.data, d.width, d.color_spec, self.x, self.y, self.w, self.h)
        return self._wrap(frame, data, d.with_(width=self.w, height=self.h))


class MirrorFilter(Filter):
    def apply(self, frame):
        return self._wrap(frame, pp.mirror(frame.data, frame.desc.width, frame.desc.color_spec))


class FlipFilter(Filter):
    def apply(self, frame):
        return self._wrap(frame, pp.flip(frame.data))


class GammaFilter(Filter):
    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.gamma = float(cfg) if cfg else 2.2

    def apply(self, frame):
        return self._wrap(frame, pp.gamma_correct(frame.data, self.gamma))


class GrayscaleFilter(Filter):
    def apply(self, frame):
        d = frame.desc
        return self._wrap(frame, pp.grayscale(frame.data, d.width, d.color_spec))


class MatrixFilter(Filter):
    """matrix:a:b:c:d:e:f:g:h:i — 3x3 row-major (ref: capture_filter/matrix.cpp)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        vals = [float(v) for v in cfg.split(":") if v]
        if len(vals) != 9:
            raise ValueError("matrix needs 9 coefficients")
        self.matrix = np.array(vals).reshape(3, 3)

    def apply(self, frame):
        d = frame.desc
        return self._wrap(frame, pp.color_matrix(frame.data, d.width, d.color_spec, self.matrix))


class BlankFilter(Filter):
    """blank[:x:y:w:h] (ref: capture_filter/blank.cpp)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        parts = [int(p) for p in cfg.split(":") if p]
        self.rect = parts if len(parts) == 4 else None

    def apply(self, frame):
        d = frame.desc
        if self.rect:
            x, y, w, h = self.rect
        else:
            x, y, w, h = 0, 0, d.width, d.height
        return self._wrap(frame, pp.blank_region(frame.data, d.width, d.color_spec, x, y, w, h))


class NoiseFilter(Filter):
    """noise[:amount] (ref: capture_filter/noise.cpp); one generator per
    filter and device, seeded with 0 as the JAX package seeds its key."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.amount = int(cfg) if cfg else 16
        self._gens: Dict[torch.device, torch.Generator] = {}

    def apply(self, frame):
        dev = frame.data.device
        gen = self._gens.get(dev)
        if gen is None:
            gen = self._gens[dev] = torch.Generator(device=dev).manual_seed(0)
        return self._wrap(frame, pp.add_noise(frame.data, gen, self.amount))


class EveryFilter(Filter):
    """every:N — keep 1 of N frames (ref: capture_filter/every.cpp)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        parts = cfg.split(":")
        self.num = int(parts[0]) if parts[0] else 2
        self.count = 0

    def apply(self, frame):
        keep = self.count % self.num == 0
        self.count += 1
        if not keep:
            return None
        return self._wrap(frame, frame.data, frame.desc.with_(fps=frame.desc.fps / self.num))


class DisruptFilter(Filter):
    """disrupt:jitter[=<ms>][:drop=<pct>] — fault injection for robustness
    testing (ref: capture_filter/disrupt.c — jitter delays frame delivery by
    a random amount up to <ms>; `drop` additionally discards a percentage of
    frames, exercising the receive path's loss handling)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.jitter_ms = 0.0
        self.drop_pct = 0.0
        self._rng = random.Random(0x5EED)
        for part in cfg.split(":"):
            if part.startswith("jitter"):
                self.jitter_ms = float(part.partition("=")[2] or 10)
            elif part.startswith("drop"):
                self.drop_pct = float(part.partition("=")[2] or 10)

    def apply(self, frame):
        if self.drop_pct and self._rng.random() * 100.0 < self.drop_pct:
            return None
        if self.jitter_ms:
            time.sleep(self._rng.random() * self.jitter_ms / 1e3)
        return frame


class RatelimitFilter(Filter):
    """ratelimit:FPS (ref: capture_filter/ratelimit.c)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.fps = float(cfg) if cfg else 30.0
        self._last = 0.0

    def apply(self, frame):
        now = time.monotonic()
        if now - self._last < 1.0 / self.fps:
            return None
        self._last = now
        return frame


class LogoFilter(Filter):
    """logo:file.npy[:x:y] — blits an RGBA image (H, W, 4 uint8) (ref:
    capture_filter/logo.cpp)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        parts = cfg.split(":")
        self.logo = np.load(parts[0]) if parts and parts[0] else np.zeros((16, 16, 4), np.uint8)
        self.x = int(parts[1]) if len(parts) > 1 else 0
        self.y = int(parts[2]) if len(parts) > 2 else 0

    def apply(self, frame):
        d = frame.desc
        return self._wrap(frame, pp.logo_blit(frame.data, d.width, d.color_spec, self.logo, self.x, self.y))


class ChangePixfmtFilter(Filter):
    """change_pixfmt:CODEC (ref: capture_filter/change_pixfmt.c)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.to = get_codec_from_name(cfg)
        if self.to == Codec.NONE:
            raise ValueError(f"change_pixfmt: unknown codec {cfg!r}")

    def apply(self, frame):
        d = frame.desc
        data = pixfmt.convert_frame(frame.data, d.width, d.color_spec, self.to)
        return self._wrap(frame, data, d.with_(color_spec=self.to))


class BorderFilter(Filter):
    """border[:color=rrggbb][:width=<x>][:height=<y>]
    (ref: vo_postprocess/border.c — default yellow, width 10).

    The RGB color is converted into the frame's own codec by rendering one
    full-width RGBA row through the conversion registry on the frame's
    device, so the border is drawn natively in any packed format (UYVY,
    v210, R10k, ...).
    """

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.color = (0xFF, 0xFF, 0x00)
        self.bw = 10
        self.bh = 10
        for item in [p for p in cfg.split(":") if p]:
            if item.startswith("color="):
                c = item[6:].lstrip("#")
                self.color = tuple(int(c[i : i + 2], 16) for i in (0, 2, 4))
            elif item.startswith("width="):
                self.bw = int(item[6:])
            elif item.startswith("height="):
                self.bh = int(item[7:])
        self._row_cache: Dict[tuple, torch.Tensor] = {}

    def _pattern_row(self, width: int, codec: Codec, device: torch.device) -> torch.Tensor:
        key = (width, codec, device)
        row = self._row_cache.get(key)
        if row is None:
            rgba = np.zeros((1, width * 4), np.uint8)
            rgba[0, 0::4], rgba[0, 1::4], rgba[0, 2::4] = self.color
            rgba[0, 3::4] = 0xFF
            row = pixfmt.convert_frame(torch.as_tensor(rgba, device=device), width, Codec.RGBA, codec)[0]
            self._row_cache[key] = row
        return row

    def apply(self, frame):
        d = frame.desc
        arr = frame.data.clone()
        row = self._pattern_row(d.width, d.color_spec, arr.device)
        bh = min(self.bh, d.height // 2)
        if bh:
            arr[:bh] = row
            arr[-bh:] = row
        lbytes = vc_get_linesize(min(self.bw, d.width // 2), d.color_spec)
        if lbytes:
            arr[:, :lbytes] = row[:lbytes]
            arr[:, arr.shape[1] - lbytes :] = row[:lbytes]
        return self._wrap(frame, arr)


class SplitFilter(Filter):
    """split:WxH — split the frame into a W x H tile grid
    (ref: vo_postprocess/split.c; tile order row-major)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        w, _, h = cfg.replace(":", "x").partition("x")
        self.gw, self.gh = int(w), int(h)

    def apply(self, frame):
        return vf_split(frame, self.gw, self.gh)


class DelayFilter(Filter):
    """delay:[seconds=<s>|frames=<f>] (ref: vo_postprocess/delay.c)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.seconds = 0.0
        self.frames = 0
        if cfg.startswith("seconds="):
            self.seconds = float(cfg[8:])
        elif cfg.startswith("frames="):
            self.frames = int(cfg[7:])
        else:
            raise ValueError("delay takes seconds=<s> or frames=<f>")
        self._queue: List[VideoFrame] = []
        self._n: Optional[int] = None

    def apply(self, frame):
        if self._n is None:
            self._n = self.frames or max(1, round(self.seconds * frame.desc.fps))
        self._queue.append(frame)
        if len(self._queue) <= self._n:
            return None
        return self._queue.pop(0)


class DoubleFramerateFilter(Filter):
    """temporal_deint/double_framerate: bob each field into its own output
    frame at 2x fps (ref: vo_postprocess/temporal-deint.c double_framerate
    path — input interlaced-merged, output progressive).  Returns a LIST of
    two frames; chains and display loops fan them out in order.
    """

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.force = cfg == "force"

    def apply(self, frame):
        d = frame.desc
        if d.interlacing != InterlacingType.INTERLACED_MERGED and not self.force:
            return frame
        out_desc = d.with_(fps=d.fps * 2, interlacing=InterlacingType.PROGRESSIVE)
        f0 = self._wrap(frame, pp.deinterlace_bob_even(frame.data), out_desc)
        f1 = self._wrap(frame, pp.deinterlace_bob_odd(frame.data), out_desc)
        return [f0, f1]


class TextFilter(Filter):
    """text[:x=<x>:y=<y>:h=<text_height>]:t=<text>
    (ref: vo_postprocess/text.c — draws a label onto the frame; the reference
    rasterizes via ImageMagick/Wand, here PIL's bitmap font renders a mask on
    the host, and the label is drawn on the frame's device: the touched band
    of rows goes to RGBA, the mask's pixels turn white, the band goes back
    to the frame's codec).
    """

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.x, self.y, self.h = 20, 20, 16
        self.text = ""
        for item in [p for p in cfg.split(":") if p]:
            if item.startswith("x="):
                self.x = int(item[2:])
            elif item.startswith("y="):
                self.y = int(item[2:])
            elif item.startswith("h="):
                self.h = int(item[2:])
            elif item.startswith("t="):
                self.text = item[2:]
            elif not self.text:
                self.text = item
        self._mask: Optional[np.ndarray] = None  # lazily rendered [mh, mw] bool

    def _render_mask(self) -> np.ndarray:
        if self._mask is not None:
            return self._mask
        try:
            from PIL import Image, ImageDraw

            probe = Image.new("L", (8, 8))
            bbox = ImageDraw.Draw(probe).textbbox((0, 0), self.text)
            im = Image.new("L", (max(bbox[2] + 2, 1), max(bbox[3] + 2, 1)))
            ImageDraw.Draw(im).text((1, 1), self.text, fill=255)
            mask = np.asarray(im) > 127
            # integer-upscale to requested height
            scale = max(1, self.h // max(mask.shape[0], 1))
            mask = np.repeat(np.repeat(mask, scale, axis=0), scale, axis=1)
        except ImportError:  # no PIL: a solid box, as the JAX package draws
            mask = np.ones((self.h, self.h * max(len(self.text), 1) // 2), bool)
        self._mask = mask
        return mask

    def apply(self, frame):
        d = frame.desc
        mask = self._render_mask()
        mh = min(mask.shape[0], d.height - self.y)
        mw = min(mask.shape[1], d.width - self.x)
        if mh <= 0 or mw <= 0:
            return frame
        arr = frame.data.clone()
        band = arr[self.y : self.y + mh]
        rgba = pixfmt.convert_frame(band, d.width, d.color_spec, Codec.RGBA).reshape(mh, d.width, 4)
        m = torch.as_tensor(np.ascontiguousarray(mask[:mh, :mw]), device=arr.device)
        rgba[:, self.x : self.x + mw][m] = 255
        back = pixfmt.convert_frame(rgba.reshape(mh, -1), d.width, Codec.RGBA, d.color_spec)
        band[:, : back.shape[1]] = back
        return self._wrap(frame, arr)


class Interlaced3dFilter(Filter):
    """interlaced_3d: merge a 2-tile (left/right eye) 3D frame into one
    line-interleaved frame for passive-3D displays
    (ref: vo_postprocess/3d-interlaced.c — even rows = left eye, odd =
    right, output height doubled at half vertical resolution per eye)."""

    def apply(self, frame):
        if frame.desc.tile_count != 2 or len(frame.tiles) != 2:
            log.warning("interlaced_3d needs a 2-tile 3D frame; passing through")
            return frame
        left, right = frame.tiles
        out = torch.stack([left, right], dim=1).reshape(left.shape[0] * 2, left.shape[1])
        out_frame = VideoFrame(frame.desc.with_(height=frame.desc.height * 2, tile_count=1), [out])
        out_frame.timestamp = frame.timestamp
        return out_frame


class AddFrameFilter(Filter):
    """add_frame:every=<num> — repeat every <num>-th frame to raise the frame
    rate, e.g. every=5 converts 50p to 60p (ref: vo_postprocess/add_frame.c).
    """

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.every = 5
        for item in [p for p in cfg.split(":") if p]:
            if item.startswith(("every=", "e=")):
                self.every = int(item.split("=", 1)[1])
            # "nodelay" is a buffering knob; this implementation has no extra delay
        self._count = 0

    def apply(self, frame):
        self._count += 1
        new_fps = frame.desc.fps * (self.every + 1) / self.every
        out = self._wrap(frame, frame.data, frame.desc.with_(fps=new_fps))
        if self._count % self.every == 0:
            return [out, self._wrap(frame, frame.data, out.desc)]
        return out


class Matrix2Filter(Filter):
    """matrix2:a:..:i | matrix2:y601_to_y709 — 3x3 on unpacked YCbCr
    (ref: capture_filter/matrix2.c)."""

    Y601_TO_Y709 = [1, -0.11555, -0.207938, 0, 1.01864, 0.114618, 0, 0.075049, 1.025327]

    def __init__(self, cfg: str):
        super().__init__(cfg)
        if cfg.strip() == "y601_to_y709":
            vals = self.Y601_TO_Y709
        else:
            vals = [float(v) for v in cfg.split(":") if v]
        if len(vals) != 9:
            raise ValueError("matrix2 needs 9 coefficients or y601_to_y709")
        self.matrix = np.array(vals).reshape(3, 3)

    def apply(self, frame):
        d = frame.desc
        if d.color_spec != Codec.UYVY:
            log.warning("matrix2: only YCbCr (UYVY) inputs supported")
            return frame
        return self._wrap(frame, pp.matrix2_uyvy(frame.data, d.width, self.matrix))


class OverridePropFilter(Filter):
    """override_prop:fps=<n>|size=<X>x<Y>|codec=<c> — override video
    properties without touching the content (ref:
    capture_filter/override_prop.c; values are not validated, like the
    reference warns)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self.kw: Dict[str, object] = {}
        for tok in [t for t in cfg.split(":") if t]:
            key, _, val = tok.partition("=")
            if key == "fps":
                if val.endswith("i"):
                    self.kw["interlacing"] = InterlacingType.INTERLACED_MERGED
                    val = val[:-1]
                self.kw["fps"] = float(val)
            elif key == "size":
                w, _, h = val.partition("x")
                self.kw["width"], self.kw["height"] = int(w), int(h)
            elif key == "codec":
                self.kw["color_spec"] = get_codec_from_name(val)
            else:
                raise ValueError(f"override_prop: unknown option {tok}")

    def apply(self, frame):
        return self._wrap(frame, frame.data, frame.desc.with_(**self.kw))


class ColorFilter(Filter):
    """color — log the center pixel's YCbCr, pass frames through
    (ref: capture_filter/color.c: 'currently only center pixel is
    printed').  Only the centre row is converted, on the frame's device."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self._last_log = 0.0

    def apply(self, frame):
        now = time.monotonic()
        if now - self._last_log >= 1.0:  # once per second, not per frame
            self._last_log = now
            d = frame.desc
            cy = d.height // 2
            cx = (d.width // 2) // 2 * 4  # align to a UYVY group
            try:
                row = pixfmt.convert_frame(frame.data[cy : cy + 1], d.width, d.color_spec, Codec.UYVY)
            except ValueError:  # no conversion to UYVY: nothing to print
                return frame
            u, y, v = row[0, cx : cx + 3].tolist()
            log.info(f"[color] Center color is Y={y} U={u} V={v}")
        return frame


class Temporal3dFilter(Filter):
    """temporal_3d — pair consecutive frames into one 2-tile 3D frame at
    half the rate (ref: capture_filter/temporal_3d.c)."""

    def __init__(self, cfg: str):
        super().__init__(cfg)
        self._pending: Optional[VideoFrame] = None

    def apply(self, frame):
        if self._pending is None:
            self._pending = frame
            return None
        left, self._pending = self._pending, None
        d = left.desc
        out = VideoFrame(d.with_(tile_count=2, fps=d.fps / 2), [left.data, frame.data])
        out.timestamp = left.timestamp
        return out


class DisplayFilter(Filter):
    """display:<display_cfg> — tee frames into a side display while passing
    them through (ref: capture_filter/display.c)."""

    display_spec: Optional[str] = None  # subclass override (preview)

    def __init__(self, cfg: str):
        super().__init__(cfg)
        from ultragrid_tpu_torch.modules.video_display import initialize_video_display

        spec = self.display_spec or cfg
        if not spec:
            raise ValueError("usage: display:<display_cfg>")
        self.display = initialize_video_display(spec)
        self._configured = False

    def apply(self, frame):
        if self.display is not None:
            if not self._configured or self.display.desc != frame.desc:
                self.display.reconfigure(frame.desc)
                self._configured = True
            try:
                self.display.put_frame(frame, blocking=False)
            except Exception as exc:  # noqa: BLE001 — a side display must never stall capture
                log.warning(f"side display failed: {exc}")
                self.display = None
        return frame

    def done(self):
        if self.display is not None:
            self.display.put_frame(None)
            self.display.done()


class PreviewFilter(DisplayFilter):
    """preview — tee into the preview unix-socket display (ref:
    capture_filter/preview.cpp; ``modules/ipc_display.py``).  Degrades to
    passthrough, with the JAX package's warning, only when the display
    cannot be built: no preview consumer is listening."""

    def __init__(self, cfg: str):
        try:
            super().__init__("preview" + (":" + cfg if cfg else ""))
        except (ValueError, OSError) as exc:
            log.warning(f"preview unavailable ({exc}); passing through")
            Filter.__init__(self, cfg)
            self.display = None


_FILTERS = {
    "scale": ScaleFilter,
    "resize": ScaleFilter,
    "deinterlace": DeinterlaceFilter,
    "deinterlace_blend": lambda cfg: DeinterlaceFilter("blend"),
    "deinterlace_linear": lambda cfg: DeinterlaceFilter("linear"),
    "deinterlace_bob": lambda cfg: DeinterlaceFilter("bob"),
    "interlace": InterlaceFilter,
    "crop": CropFilter,
    "mirror": MirrorFilter,
    "flip": FlipFilter,
    "gamma": GammaFilter,
    "grayscale": GrayscaleFilter,
    "matrix": MatrixFilter,
    "blank": BlankFilter,
    "noise": NoiseFilter,
    "every": EveryFilter,
    "disrupt": DisruptFilter,
    "ratelimit": RatelimitFilter,
    "logo": LogoFilter,
    "change_pixfmt": ChangePixfmtFilter,
    "border": BorderFilter,
    "split": SplitFilter,
    "delay": DelayFilter,
    "double_framerate": DoubleFramerateFilter,
    "temporal_deint": DoubleFramerateFilter,
    "text": TextFilter,
    "interlaced_3d": Interlaced3dFilter,
    "3d-interlaced": Interlaced3dFilter,
    "add_frame": AddFrameFilter,
    "matrix2": Matrix2Filter,
    "override_prop": OverridePropFilter,
    "color": ColorFilter,
    "temporal_3d": Temporal3dFilter,
    "display": DisplayFilter,
    "preview": PreviewFilter,
}

for _name, _cls in _FILTERS.items():
    register_module(_name, LibraryClass.CAPTURE_FILTER, _cls)
    register_module(_name, LibraryClass.VO_POSTPROCESS, _cls)


class FilterChain:
    """Comma-separated filter chain (ref: capture_filter.c chain init)."""

    def __init__(self, spec: str):
        self.filters: List[Filter] = []
        for part in [p for p in (spec or "").split(",") if p]:
            name, _, cfg = part.partition(":")
            cls = _FILTERS.get(name)
            if cls is None:
                raise ValueError(f"unknown filter {name!r}")
            self.filters.append(cls(cfg))

    def apply(self, frame: Optional[VideoFrame]):
        """Run the chain.  Filters may return None (frame consumed), one
        frame, or a list of frames (e.g. double_framerate); the chain fans
        lists out through the remaining filters and flattens the result."""
        frames = [frame] if frame is not None else []
        for f in self.filters:
            nxt: List[VideoFrame] = []
            for fr in frames:
                r = f.apply(fr)
                if r is None:
                    continue
                nxt.extend(r if isinstance(r, list) else [r])
            frames = nxt
        if not frames:
            return None
        return frames if len(frames) > 1 else frames[0]
