"""RTP payload types and payload headers (wire-compatible).

The port's copy of ``ultragrid_tpu/net/rtp_types.py`` (jax-free).

ref: src/rtp/rtp_types.h:63-161; header writers src/transmit.c:482-538
(video), :727-740 (FEC), :498-514 (audio).  All words are network order.
"""

from __future__ import annotations

import math
import struct
from typing import Optional, Tuple

from ultragrid_tpu_torch.types import Codec, InterlacingType, VideoDesc, get_codec_from_fourcc, get_fourcc

# payload types (ref: rtp_types.h:63-80)
PT_VIDEO = 20
PT_AUDIO = 21
PT_VIDEO_LDGM = 22
PT_ENCRYPT_VIDEO = 24
PT_ENCRYPT_AUDIO = 25
PT_JPEG = 26
PT_VIDEO_RS = 27
PT_ENCRYPT_VIDEO_LDGM = 29
PT_ENCRYPT_VIDEO_RS = 30
PT_AUDIO_RS = 35
PT_ENCRYPT_AUDIO_RS = 36
PT_H264 = 96

RTP_HDR_LEN = 12
VIDEO_PAYLOAD_HDR_LEN = 24
FEC_PAYLOAD_HDR_LEN = 20
AUDIO_PAYLOAD_HDR_LEN = 20


def video_rtp_ts(timestamp: float) -> int:
    """The 90 kHz RTP timestamp a video frame stamped ``timestamp`` seconds
    goes out with (``Tx.send_video``, truncated)."""
    return int(timestamp * 90000) & 0xFFFFFFFF


def received_rtp_ts(timestamp: float) -> int:
    """The RTP timestamp back from a received frame's ``timestamp``, which
    the receiver sets to the RTP timestamp over 90 kHz."""
    return int(round(timestamp * 90000)) & 0xFFFFFFFF


def fec_pt(fec_type: str, encrypted: bool = False) -> int:
    """ref: fec_pt_from_fec_type."""
    if fec_type == "ldgm":
        return PT_ENCRYPT_VIDEO_LDGM if encrypted else PT_VIDEO_LDGM
    if fec_type == "rs":
        return PT_ENCRYPT_VIDEO_RS if encrypted else PT_VIDEO_RS
    return PT_ENCRYPT_VIDEO if encrypted else PT_VIDEO


def format_interl_fps_word(interlacing: InterlacingType, fps: float) -> int:
    """ref: format_interl_fps_hdr_row, transmit.c:516-538."""
    fpsi = int(round(fps))
    fpsd, fd, fi = 1, 0, 0
    if fps > 1.0 and abs(fps - round(fps) / 1.001) < 0.005:
        fd = 1
    elif fpsi < 1.0 or fps < 1.0:
        fpsi = int(round(1.0 / fps))
        fi = 1
    return (int(interlacing) << 29) | (fpsi << 19) | (fpsd << 15) | (fd << 14) | (fi << 13)


def parse_interl_fps_word(word: int) -> Tuple[InterlacingType, float]:
    interl = InterlacingType((word >> 29) & 0x7)
    fps = (word >> 19) & 0x3FF
    fpsd = (word >> 15) & 0xF
    fd = (word >> 14) & 1
    fi = (word >> 13) & 1
    value = float(fps) / max(fpsd, 1)
    if fd:
        value /= 1.001
    if fi:
        value = 1.0 / value if value else 0.0
    return interl, value


def pack_video_header(
    desc: VideoDesc, buffer_idx: int, offset: int, frame_len: int, substream: int = 0
) -> bytes:
    """6-word video payload header (ref: format_video_header, transmit.c:482-496)."""
    w0 = ((substream & 0x3FF) << 22) | (buffer_idx & 0x3FFFFF)
    w3 = (desc.width << 16) | desc.height
    w4 = get_fourcc(desc.color_spec)
    w5 = format_interl_fps_word(desc.interlacing, desc.fps)
    # note: fourcc (w4) is NOT byte-swapped (ref: survey 8.3)
    return struct.pack("!IIII", w0, offset, frame_len, w3) + struct.pack("<I", w4) + struct.pack("!I", w5)


# every packet of a stream carries identical format words (w3/w4/w5); cache
# the decoded VideoDesc so the per-packet hot loop does one dict hit instead
# of fourcc lookup + fps decode + dataclass construction
_desc_cache: dict = {}


def parse_video_header(data: bytes):
    w0, offset, frame_len, w3 = struct.unpack("!IIII", data[:16])
    substream = w0 >> 22
    buffer_idx = w0 & 0x3FFFFF
    fmt = bytes(data[12:24])  # w3 | w4 | w5
    desc = _desc_cache.get(fmt)
    if desc is None:
        (w4,) = struct.unpack("<I", data[16:20])
        (w5,) = struct.unpack("!I", data[20:24])
        width, height = w3 >> 16, w3 & 0xFFFF
        codec = get_codec_from_fourcc(w4)
        interl, fps = parse_interl_fps_word(w5)
        desc = VideoDesc(width, height, codec, fps, interl)
        if len(_desc_cache) < 512:
            _desc_cache[fmt] = desc
    return substream, buffer_idx, offset, frame_len, desc


def pack_fec_header(
    buffer_idx: int, offset: int, frame_len: int, k: int, m: int, c: int, seed: int,
    substream: int = 0,
) -> bytes:
    """5-word FEC payload header (ref: transmit.c:730-739)."""
    w0 = ((substream & 0x3FF) << 22) | (buffer_idx & 0x3FFFFF)
    w3 = (k << 19) | (m << 6) | c
    return struct.pack("!IIIII", w0, offset, frame_len, w3, seed)


def parse_fec_header(data: bytes):
    w0, offset, frame_len, w3, seed = struct.unpack("!IIIII", data[:20])
    substream = w0 >> 22
    buffer_idx = w0 & 0x3FFFFF
    k = w3 >> 19
    m = (w3 >> 6) & 0x1FFF
    c = w3 & 0x3F
    return substream, buffer_idx, offset, frame_len, k, m, c, seed


def pack_audio_header(
    channel: int, buffer_idx: int, offset: int, data_len: int,
    bps: int, sample_rate: int, codec_tag: int,
) -> bytes:
    """5-word audio payload header (ref: format_audio_header, transmit.c:498-514)."""
    w0 = ((channel & 0x3FF) << 22) | (buffer_idx & 0x3FFFFF)
    w3 = ((bps * 8) << 26) | sample_rate
    return struct.pack("!IIIII", w0, offset, data_len, w3, codec_tag)


def parse_audio_header(data: bytes):
    w0, offset, data_len, w3, tag = struct.unpack("!IIIII", data[:20])
    channel = w0 >> 22
    buffer_idx = w0 & 0x3FFFFF
    bps = (w3 >> 26) // 8
    sample_rate = w3 & 0x3FFFFFF
    return channel, buffer_idx, offset, data_len, bps, sample_rate, tag
