"""Pixel-format conversion registry and selection on tensors.

Port of ``ultragrid_tpu/ops/pixfmt.py``: the reference's line-decoder table
(ref: decoders[] src/pixfmt_conv.c:3041-3103, get_decoder_from_to
:3110-3125, get_best_decoder_from :3148-3172, compare_pixdesc
src/video_codec.c:1149-1193) with one entry per (in, out) pair, each a
function over a whole frame ``uint8[H, linesize] -> uint8[H, out_linesize]``
in integer tensor ops.  The JAX package runs these as XLA code outside any
Pallas kernel; here they are plain PyTorch on the frame's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ultragrid_tpu_torch.device import get_device
from ultragrid_tpu_torch.types import Codec, get_codec_info, vc_get_linesize

# fn(src_u8[H, in_linesize], width) -> u8[H, out_linesize]
ConvFn = Callable[[torch.Tensor, int], torch.Tensor]

_DECODERS: Dict[Tuple[Codec, Codec], ConvFn] = {}

# preference order: depth, subsampling, colorspace (ref: pixfmt_conv_pref,
# src/video_codec.c:80)
PIXFMT_CONV_PREF = "dsc"


def set_pixfmt_conv_policy(policy: str) -> None:
    """--conv-policy: permutation of 'dsc' ordering depth/subsampling/color
    preference in conversion ranking (ref: set_pixfmt_conv_policy,
    host.cpp:344-367)."""
    global PIXFMT_CONV_PREF
    if sorted(policy) != ["c", "d", "s"]:
        raise ValueError(f"conv-policy must be a permutation of 'dsc', got {policy!r}")
    PIXFMT_CONV_PREF = policy


def register(in_codec: Codec, out_codec: Codec):
    def deco(fn: ConvFn) -> ConvFn:
        _DECODERS[(in_codec, out_codec)] = fn
        return fn

    return deco


def _identity(src: torch.Tensor, width: int) -> torch.Tensor:
    return src


def get_decoder_from_to(in_codec: Codec, out_codec: Codec) -> Optional[ConvFn]:
    """Conversion function or None (ref: get_decoder_from_to, pixfmt_conv.c:3110)."""
    if in_codec == out_codec:
        return _DECODERS.get((in_codec, out_codec), _identity)
    return _DECODERS.get((in_codec, out_codec))


@dataclasses.dataclass(frozen=True)
class PixfmtDesc:
    depth: int
    subsampling: int
    rgb: bool


def get_pixfmt_desc(codec: Codec) -> PixfmtDesc:
    info = get_codec_info(codec)
    return PixfmtDesc(info.bits_per_channel, int(info.subsampling), info.rgb)


def compare_pixdesc(a: PixfmtDesc, b: PixfmtDesc, src: PixfmtDesc) -> int:
    """Less = better (ref: compare_pixdesc, src/video_codec.c:1149-1193)."""
    for feature in PIXFMT_CONV_PREF:
        if feature == "d":
            if a.depth != b.depth and (a.depth < src.depth or b.depth < src.depth):
                return b.depth - a.depth
        elif feature == "s":
            if a.subsampling != b.subsampling and (
                a.subsampling < src.subsampling or b.subsampling < src.subsampling
            ):
                return b.subsampling - a.subsampling
        elif feature == "c":
            if a.rgb != b.rgb:
                return -1 if a.rgb == src.rgb else 1
    for feature in PIXFMT_CONV_PREF:
        if feature == "d" and a.depth != b.depth:
            return a.depth - b.depth
        if feature == "s" and a.subsampling != b.subsampling:
            return a.subsampling - b.subsampling
    return 0


def get_best_decoder_from(
    in_codec: Codec, out_candidates: Sequence[Codec]
) -> Tuple[Optional[ConvFn], Optional[Codec]]:
    """Pick the best output codec we can convert to (ref: pixfmt_conv.c:3148-3172)."""
    if in_codec in out_candidates:
        return _identity, in_codec
    candidates = [c for c in out_candidates if get_decoder_from_to(in_codec, c)]
    if not candidates:
        return None, None
    src_desc = get_pixfmt_desc(in_codec)

    def cmp(ca: Codec, cb: Codec) -> int:
        r = compare_pixdesc(get_pixfmt_desc(ca), get_pixfmt_desc(cb), src_desc)
        return r if r != 0 else int(ca) - int(cb)

    candidates.sort(key=functools.cmp_to_key(cmp))
    best = candidates[0]
    return get_decoder_from_to(in_codec, best), best


def convert_frame(src, width: int, in_codec: Codec, out_codec: Codec, device="cuda") -> torch.Tensor:
    """Convert a packed frame between pixel formats.

    ``src``: uint8 [H, >= vc_get_linesize(width, in_codec)] (a shorter line
    is zero-padded), a tensor (converted on its own device) or an array
    (copied to ``device``, the card unless the caller names another).
    Returns uint8 [H, vc_get_linesize(width, out_codec)] on that device.
    """
    fn = get_decoder_from_to(in_codec, out_codec)
    if fn is None:
        raise ValueError(f"no conversion {Codec(in_codec).name} -> {Codec(out_codec).name}")
    if not isinstance(src, torch.Tensor):
        src = torch.as_tensor(src, device=get_device(device))
    if src.dtype != torch.uint8 or src.dim() != 2:
        raise ValueError(f"frame must be uint8 [H, linesize], got {src.dtype} {tuple(src.shape)}")
    in_ls = vc_get_linesize(width, in_codec)
    if src.shape[1] < in_ls:
        src = torch.nn.functional.pad(src, (0, in_ls - src.shape[1]))
    out = fn(src, width)
    # the conversions produce whole groups; trim or zero-pad to the
    # canonical line size
    out_ls = vc_get_linesize(width, out_codec)
    if out.shape[1] > out_ls:
        out = out[:, :out_ls]
    elif out.shape[1] < out_ls:
        out = torch.nn.functional.pad(out, (0, out_ls - out.shape[1]))
    return out.contiguous()


def conversion_pairs() -> Sequence[Tuple[Codec, Codec]]:
    return sorted(_DECODERS.keys())


# populate the registry
import ultragrid_tpu_torch.ops.convs_yuv  # noqa: E402,F401
import ultragrid_tpu_torch.ops.convs_rgb  # noqa: E402,F401

# explicit identity rows present in the reference decoders[] table
# (vc_copylineRGBA / vc_copylineRGB memcpy entries, pixfmt_conv.c); identity
# for every other codec is implicit in get_decoder_from_to
for _c in (Codec.RGBA, Codec.RGB):
    _DECODERS.setdefault((_c, _c), _identity)
