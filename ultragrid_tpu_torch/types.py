"""The video types the port uses: codec ids, codec table, video description, frames.

The port's own copy of ``ultragrid_tpu/types.py``'s codec registry, so that
it imports nothing of the JAX package.  Codec ids keep the reference's
``IntEnum`` values (ref: codec_t, src/types.h:62-111) and the per-codec
metadata is the reference table's (ref: codec_info[],
src/video_codec.c:123-207).  ``tests/test_torch_types.py`` holds every value
here equal to the reference's.

One difference by design: :func:`vc_get_linesize` raises for a compressed
(opaque) codec, whose frames are flat byte strings with no lines.
"""

from __future__ import annotations

import dataclasses
import enum
from fractions import Fraction
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = [
    "Codec",
    "Subsampling",
    "InterlacingType",
    "VideoDesc",
    "VideoFrame",
    "CodecInfo",
    "get_codec_info",
    "get_bpp",
    "get_bits_per_component",
    "get_subsampling",
    "is_codec_opaque",
    "is_codec_interframe",
    "codec_is_a_rgb",
    "codec_is_planar",
    "codec_is_const_size",
    "get_fourcc",
    "get_codec_from_fourcc",
    "get_codec_from_name",
    "vc_get_linesize",
    "vc_get_size",
    "vc_get_datalen",
    "codec_get_planes_subsampling",
    "to_fourcc",
    "MAX_PADDING",
    "PIX_BLOCK_LCM",
    "KHZ_90",
]

# Conversions may read up to this number of bytes past the line end; buffers
# over-allocate accordingly (ref: src/video_codec.h:61-64).
MAX_PADDING = 64
# RTP media clock (ref: src/types.h:152).
KHZ_90 = 90000


def to_fourcc(a: str, b: str, c: str, d: str) -> int:
    return ord(a) | (ord(b) << 8) | (ord(c) << 16) | (ord(d) << 24)


class Codec(enum.IntEnum):
    """Video codec / pixel format ids (values as the reference's)."""

    NONE = 0
    RGBA = 1
    UYVY = 2
    YUYV = 3
    VUYA = 4
    R10k = 5
    R12L = 6
    v210 = 7
    DVS10 = 8
    DXT1 = 9
    DXT1_YUV = 10
    DXT5 = 11
    RGB = 12
    JPEG = 13
    JPEG_XS = 14
    RAW = 15
    H264 = 16
    H265 = 17
    VP8 = 18
    VP9 = 19
    BGR = 20
    J2K = 21
    J2KR = 22
    HW_VDPAU = 23
    HFYU = 24
    FFV1 = 25
    CFHD = 26
    RG48 = 27
    AV1 = 28
    I420 = 29
    Y216 = 30
    Y416 = 31
    PRORES = 32
    PRORES_4444 = 33
    PRORES_4444_XQ = 34
    PRORES_422_HQ = 35
    PRORES_422 = 36
    PRORES_422_PROXY = 37
    PRORES_422_LT = 38
    APV = 39
    DRM_PRIME = 40


class Subsampling(enum.IntEnum):
    """Chroma subsampling of a pixel format; OPAQUE for compressed codecs."""

    OPAQUE = 0
    S420 = 420
    S422 = 422
    S444 = 444
    S4444 = 4444


class InterlacingType(enum.IntEnum):
    """Interlacing (ref: src/types.h interlacing_t)."""

    PROGRESSIVE = 0
    UPPER_FIELD_FIRST = 1
    LOWER_FIELD_FIRST = 2
    INTERLACED_MERGED = 3
    SEGMENTED_FRAME = 4


VCF_NONE = 0
VCF_RGB = 1 << 0
VCF_INTERFRAME = 1 << 1
VCF_CONST_SIZE = 1 << 2


@dataclasses.dataclass(frozen=True)
class CodecInfo:
    """Per-codec metadata (ref: struct codec_info_t, src/video_codec.c:104-116)."""

    name: str
    name_long: str
    fcc: int
    block_size_bytes: int
    block_size_pixels: int
    h_align: int
    bits_per_channel: int
    flags: int
    subsampling: Subsampling
    file_extension: Optional[str]

    @property
    def bpp(self) -> float:
        """Bytes per pixel (0 for a codec without pixel blocks)."""
        if self.block_size_pixels == 0:
            return 0.0
        return self.block_size_bytes / self.block_size_pixels

    @property
    def rgb(self) -> bool:
        return bool(self.flags & VCF_RGB)

    @property
    def opaque(self) -> bool:
        return self.subsampling == Subsampling.OPAQUE


# Least common multiple of pixel-block sizes; the packetizer aligns split
# points of uncompressed video to this many pixels (ref: src/video_codec.h:64).
PIX_BLOCK_LCM = 24

_C, _S, _f = Codec, Subsampling, to_fourcc

CODEC_INFO: Dict[Codec, CodecInfo] = {
    _C.NONE: CodecInfo("(none)", "Undefined Codec", 0, 0, 0, 0, 0, VCF_NONE, _S.OPAQUE, None),
    _C.RGBA: CodecInfo("RGBA", "Red Green Blue Alpha 32bit", _f("R", "G", "B", "A"), 4, 1, 1, 8, VCF_RGB, _S.S4444, "rgba"),
    _C.UYVY: CodecInfo("UYVY", "YUV 4:2:2", _f("U", "Y", "V", "Y"), 4, 2, 2, 8, VCF_NONE, _S.S422, "yuv"),
    _C.YUYV: CodecInfo("YUYV", "YUV 4:2:2", _f("Y", "U", "Y", "V"), 4, 2, 2, 8, VCF_NONE, _S.S422, "yuv"),
    _C.VUYA: CodecInfo("VUYA", "VUYA 4:4:4:4", _f("V", "U", "Y", "A"), 4, 1, 1, 8, VCF_NONE, _S.S4444, "vuya"),
    _C.R10k: CodecInfo("R10k", "10-bit RGB 4:4:4", _f("R", "1", "0", "k"), 4, 1, 64, 10, VCF_RGB, _S.S444, "r10k"),
    _C.R12L: CodecInfo("R12L", "12-bit packed RGB 4:4:4 little-endian", _f("R", "1", "2", "l"), 36, 8, 8, 12, VCF_RGB, _S.S444, "r12l"),
    _C.v210: CodecInfo("v210", "10-bit YUV 4:2:2", _f("v", "2", "1", "0"), 16, 6, 48, 10, VCF_NONE, _S.S422, "v210"),
    _C.DVS10: CodecInfo("DVS10", "Centaurus 10bit YUV 4:2:2", _f("D", "S", "1", "0"), 16, 6, 48, 10, VCF_NONE, _S.S422, "dvs10"),
    _C.DXT1: CodecInfo("DXT1", "S3 Compressed Texture DXT1", _f("D", "X", "T", "1"), 1, 2, 0, 2, VCF_RGB, _S.OPAQUE, "dxt1"),
    _C.DXT1_YUV: CodecInfo("DXT1_YUV", "S3 Compressed Texture DXT1 YUV", _f("D", "X", "T", "Y"), 1, 2, 0, 2, VCF_NONE, _S.OPAQUE, "dxt1y"),
    _C.DXT5: CodecInfo("DXT5", "S3 Compressed Texture DXT5 YCoCg", _f("D", "X", "T", "5"), 1, 1, 0, 4, VCF_NONE, _S.OPAQUE, "yog"),
    _C.RGB: CodecInfo("RGB", "Red Green Blue 24bit", _f("R", "G", "B", "2"), 3, 1, 1, 8, VCF_RGB, _S.S444, "rgb"),
    _C.JPEG: CodecInfo("JPEG", "JPEG", _f("J", "P", "E", "G"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "jpg"),
    _C.JPEG_XS: CodecInfo("JPEG_XS", "JPEG XS", _f("J", "X", "S", "S"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "jxs"),
    _C.RAW: CodecInfo("raw", "Raw SDI video", _f("r", "a", "w", "s"), 1, 1, 0, 0, VCF_NONE, _S.OPAQUE, "raw"),
    _C.H264: CodecInfo("H.264", "H.264/AVC", _f("A", "V", "C", "1"), 1, 1, 0, 8, VCF_INTERFRAME, _S.OPAQUE, "h264"),
    _C.H265: CodecInfo("H.265", "H.265/HEVC", _f("H", "E", "V", "C"), 1, 1, 0, 8, VCF_INTERFRAME, _S.OPAQUE, "h265"),
    _C.VP8: CodecInfo("VP8", "Google VP8", _f("V", "P", "8", "0"), 1, 1, 0, 8, VCF_INTERFRAME, _S.OPAQUE, "vp8"),
    _C.VP9: CodecInfo("VP9", "Google VP9", _f("V", "P", "9", "0"), 1, 1, 0, 8, VCF_INTERFRAME, _S.OPAQUE, "vp9"),
    _C.BGR: CodecInfo("BGR", "Blue Green Red 24bit", _f("B", "G", "R", "2"), 3, 1, 1, 8, VCF_RGB, _S.S444, "bgr"),
    _C.J2K: CodecInfo("J2K", "JPEG 2000", _f("M", "J", "2", "C"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "j2k"),
    _C.J2KR: CodecInfo("J2KR", "JPEG 2000 RGB", _f("M", "J", "2", "R"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "j2k"),
    _C.HW_VDPAU: CodecInfo("HW_VDPAU", "VDPAU hardware surface", _f("V", "D", "P", "S"), 0, 1, 0, 8, VCF_CONST_SIZE, _S.OPAQUE, "vdpau"),
    _C.HFYU: CodecInfo("HFYU", "HuffYUV", _f("H", "F", "Y", "U"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "hfyu"),
    _C.FFV1: CodecInfo("FFV1", "FFV1", _f("F", "F", "V", "1"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "ffv1"),
    _C.CFHD: CodecInfo("CFHD", "Cineform", _f("C", "F", "H", "D"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "cfhd"),
    _C.RG48: CodecInfo("RG48", "16-bit RGB little-endian", _f("R", "G", "4", "8"), 6, 1, 1, 16, VCF_RGB, _S.S444, "rg48"),
    _C.AV1: CodecInfo("AV1", "AOMedia Video 1", _f("a", "v", "0", "1"), 1, 1, 0, 8, VCF_RGB, _S.OPAQUE, "av1"),
    _C.I420: CodecInfo("I420", "planar YUV 4:2:0", _f("I", "4", "2", "0"), 3, 2, 2, 8, VCF_NONE, _S.S420, "yuv"),
    _C.Y216: CodecInfo("Y216", "Packed 16-bit YUV 4:2:2 little-endian", _f("Y", "2", "1", "6"), 8, 2, 2, 16, VCF_NONE, _S.S422, "y216"),
    _C.Y416: CodecInfo("Y416", "Packed 16-bit YUV 4:4:4:4 little-endian", _f("Y", "4", "1", "6"), 8, 1, 1, 16, VCF_NONE, _S.S4444, "y416"),
    _C.PRORES: CodecInfo("PRORES", "Apple ProRes", 0, 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "pror"),
    _C.PRORES_4444: CodecInfo("PRORES_4444", "Apple ProRes 4444", _f("a", "p", "4", "h"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "ap4h"),
    _C.PRORES_4444_XQ: CodecInfo("PRORES_4444_XQ", "Apple ProRes 4444 (XQ)", _f("a", "p", "4", "x"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "ap4x"),
    _C.PRORES_422_HQ: CodecInfo("PRORES_422_HQ", "Apple ProRes 422 (HQ)", _f("a", "p", "c", "h"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "apch"),
    _C.PRORES_422: CodecInfo("PRORES_422", "Apple ProRes 422", _f("a", "p", "c", "n"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "apcn"),
    _C.PRORES_422_PROXY: CodecInfo("PRORES_422_PROXY", "Apple ProRes 422 (Proxy)", _f("a", "p", "c", "o"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "apco"),
    _C.PRORES_422_LT: CodecInfo("PRORES_422_LT", "Apple ProRes 422 (LT)", _f("a", "p", "c", "s"), 1, 1, 0, 8, VCF_NONE, _S.OPAQUE, "apcs"),
    _C.APV: CodecInfo("APV", "Advanced Professional Video", _f("a", "p", "v", "1"), 1, 1, 0, 0, VCF_NONE, _S.OPAQUE, "apv"),
    _C.DRM_PRIME: CodecInfo("DRM_PRIME", "DRM Prime buffer", _f("D", "R", "M", "P"), 0, 1, 0, 8, VCF_CONST_SIZE, _S.OPAQUE, "drm_prime"),
}

def get_codec_info(codec: Codec) -> CodecInfo:
    return CODEC_INFO[Codec(codec)]


def get_bpp(codec: Codec) -> float:
    return get_codec_info(codec).bpp


def get_bits_per_component(codec: Codec) -> int:
    return get_codec_info(codec).bits_per_channel


def get_subsampling(codec: Codec) -> int:
    return int(get_codec_info(codec).subsampling)


def is_codec_interframe(codec: Codec) -> bool:
    return bool(get_codec_info(codec).flags & VCF_INTERFRAME)


def codec_is_const_size(codec: Codec) -> bool:
    return bool(get_codec_info(codec).flags & VCF_CONST_SIZE)


def codec_is_a_rgb(codec: Codec) -> bool:
    return get_codec_info(codec).rgb


def is_codec_opaque(codec: Codec) -> bool:
    return get_codec_info(codec).opaque


def codec_is_planar(codec: Codec) -> bool:
    return Codec(codec) in _PLANES


def get_fourcc(codec: Codec) -> int:
    return get_codec_info(codec).fcc


def get_codec_from_fourcc(fcc: int) -> Codec:
    for c, info in CODEC_INFO.items():
        if info.fcc == fcc and c != Codec.NONE:
            return c
    return Codec.NONE


def get_codec_from_name(name: str) -> Codec:
    for c, info in CODEC_INFO.items():
        if info.name.lower() == name.lower():
            return c
    return Codec.NONE


def vc_get_linesize(width: int, codec: Codec) -> int:
    """Aligned byte length of one line (ref: src/video_codec.c:508-522).
    Raises for a compressed codec: its frames have no lines."""
    info = get_codec_info(codec)
    if info.opaque:
        raise ValueError(f"{info.name} is compressed: its frames have no lines")
    if info.h_align:
        width = (width + info.h_align - 1) // info.h_align * info.h_align
    return (width + info.block_size_pixels - 1) // info.block_size_pixels * info.block_size_bytes


# planes of a planar codec as (h, v) subsampling pairs (ref:
# pixfmt_plane_info[], src/video_codec.c:214-217)
_PLANES = {Codec.I420: ((1, 1), (2, 2), (2, 2))}


def vc_get_size(width: int, codec: Codec) -> int:
    """Unaligned byte size of ``width`` pixels (ref: src/video_codec.c:531-539);
    0 for a codec without pixel blocks."""
    info = get_codec_info(codec)
    if info.block_size_pixels == 0:
        return 0
    return (width + info.block_size_pixels - 1) // info.block_size_pixels * info.block_size_bytes


def codec_get_planes_subsampling(codec: Codec) -> Tuple[int, ...]:
    """``(h0, v0, h1, v1, ...)`` of a planar codec, padded to four planes
    with zeros as the reference's table; ``()`` for any other codec."""
    planes = _PLANES.get(Codec(codec))
    if planes is None:
        return ()
    return tuple(x for plane in planes for x in plane) + (0, 0) * (4 - len(planes))


def vc_get_datalen(width: int, height: int, codec: Codec) -> int:
    """Storage size of a frame (ref: src/video_codec.c:544-563); a compressed
    codec counts its blocks as the reference does."""
    info = get_codec_info(codec)
    if Codec(codec) in _PLANES:
        return sum(-(-width // h) * -(-height // v) for h, v in _PLANES[Codec(codec)])
    if info.opaque:
        if not info.block_size_pixels:
            return 0
        return -(-width // info.block_size_pixels) * info.block_size_bytes * height
    return vc_get_linesize(width, codec) * height


_INTERLACING_SUFFIX = {
    InterlacingType.PROGRESSIVE: "p",
    InterlacingType.UPPER_FIELD_FIRST: "uff",
    InterlacingType.LOWER_FIELD_FIRST: "lff",
    InterlacingType.INTERLACED_MERGED: "i",
    InterlacingType.SEGMENTED_FRAME: "psf",
}


@dataclasses.dataclass(frozen=True)
class VideoDesc:
    """Format descriptor (ref: struct video_desc, src/types.h:181-195)."""

    width: int
    height: int
    color_spec: Codec
    fps: float = 30.0
    interlacing: InterlacingType = InterlacingType.PROGRESSIVE
    tile_count: int = 1

    def linesize(self) -> int:
        return vc_get_linesize(self.width, self.color_spec)

    def datalen(self) -> int:
        return vc_get_datalen(self.width, self.height, self.color_spec)

    def with_(self, **kw: Any) -> "VideoDesc":
        return dataclasses.replace(self, **kw)

    def __str__(self) -> str:
        fps = f"{self.fps:.4g}"
        return (f"{self.width}x{self.height} @{fps}{_INTERLACING_SUFFIX[self.interlacing]}, "
                f"codec {get_codec_info(self.color_spec).name}")

    @staticmethod
    def parse(s: str) -> "VideoDesc":
        """Parse ``WxH @fps[pi], codec NAME`` round-trippable with __str__."""
        size_part, rest = s.split(" @", 1)
        w, h = size_part.split("x")
        fps_part, codec_part = rest.split(", codec ")
        by_suffix = {v: k for k, v in _INTERLACING_SUFFIX.items()}
        for suffix in ("psf", "uff", "lff", "i", "p"):
            if fps_part.endswith(suffix):
                return VideoDesc(int(w), int(h), get_codec_from_name(codec_part),
                                 float(fps_part[: -len(suffix)]), by_suffix[suffix])
        raise ValueError(f"cannot parse interlacing from {fps_part!r}")


def parse_fps(fps_str: str) -> Fraction:
    """Parse fps strings like ``29.97``, ``30000/1001``, ``60``.

    Mirrors get_framerate semantics (ref: test/get_framerate_test.cpp):
    29.97 -> 30000/1001, 23.98 -> 24000/1001 etc.
    """
    if "/" in fps_str:
        num, den = fps_str.split("/")
        return Fraction(int(num), int(den))
    val = float(fps_str)
    if abs(val - round(val)) < 1e-9:
        return Fraction(round(val), 1)
    # NTSC-style rates: x.97/x.98 represent round(x+1)*1000/1001
    approx = Fraction(round((val * 1001) / 1000)) * 1000 / 1001
    if abs(float(approx) - val) < 0.01:
        return Fraction(round((val * 1001) / 1000) * 1000, 1001)
    return Fraction(val).limit_denominator(100000)


class VideoFrame:
    """A frame: one array or tensor per tile plus its descriptor (ref:
    struct video_frame, src/types.h:301-342).  ``data`` is the first tile:
    uint8 ``[height, linesize]`` for a pixel format, 1-D for a planar or
    compressed codec."""

    __slots__ = ("desc", "tiles", "timestamp", "compress_start", "compress_end", "callbacks")

    def __init__(self, desc: VideoDesc, tiles: Optional[list] = None, timestamp: float = -1.0):
        self.desc = desc
        self.tiles = tiles if tiles is not None else []
        self.timestamp = timestamp  # seconds; RTP TS = timestamp * 90 kHz
        self.compress_start = 0.0
        self.compress_end = 0.0
        self.callbacks: Dict[str, Any] = {}

    @property
    def data(self):
        return self.tiles[0]

    @data.setter
    def data(self, value) -> None:
        if self.tiles:
            self.tiles[0] = value
        else:
            self.tiles.append(value)

    @staticmethod
    def alloc(desc: VideoDesc, device) -> "VideoFrame":
        """Zeroed frame storage on ``device`` (ref: vf_alloc_desc_data)."""
        flat = Codec(desc.color_spec) in _PLANES or get_codec_info(desc.color_spec).opaque
        shape = (desc.datalen(),) if flat else (desc.height, desc.linesize())
        return VideoFrame(desc, [torch.zeros(shape, dtype=torch.uint8, device=device)
                                 for _ in range(desc.tile_count)])

    def copy(self) -> "VideoFrame":
        """A frame with copies of the tiles, on their devices."""
        return VideoFrame(self.desc, [t.clone() if isinstance(t, torch.Tensor) else t.copy()
                                      for t in self.tiles], self.timestamp)

    def __repr__(self) -> str:
        return f"VideoFrame({self.desc})"
