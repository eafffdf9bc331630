"""The port's loader for the host C stages in the repository's ``native/``.

``native/jpeg_assemble.c`` (slots -> byte-stuffed JPEG entropy stream),
``native/jpeg_scan_decode.c`` (the receiver's entropy decode, restart
segments across host threads), ``native/ldgm_xor.c`` (the host LDGM
staircase encoder), ``native/udp_rx.c`` (recvmmsg batches), ``native/h264_assemble.c`` (per-macroblock
H.264 slot windows -> emulation-prevented slice payload) and
``native/h264_entropy.c`` (the own H.264 decoder and the CABAC transcoder)
and ``native/j2k_t1.c`` (the JPEG 2000 Tier-1 block coder) are plain C
shared with the JAX package.  ``cc`` builds
each into ``build/`` (gitignored) under a content hash of the source and the
flags; a failed build raises, since the port has no Python fallback for any
of them.  The libavcodec shim is the port's own copy,
``ultragrid_tpu_torch/csrc/lavc_shim.c`` (the reference's
``native/lavc_shim.c`` with its decoder fault F1 repaired); where the
FFmpeg headers are absent the lavc modules are unavailable, as in the
reference, and where they are present a failed build raises.  So is the
receiver's C depacketizer, ``ultragrid_tpu_torch/csrc/video_rx_fast.c``
(``native/video_rx_fast.c`` with fault F12 repaired: it grows the slots
before it scatters a frame wider than them), and the sender's sendmmsg
batches, ``ultragrid_tpu_torch/csrc/udp_tx.c`` (``native/udp_tx.c`` whose
pacer sleeps only while it is ahead of the schedule).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from functools import lru_cache

from ultragrid_tpu_torch._build import BUILD_DIR
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("native")  # the reference's module logger; the port's loaders raise instead of warning

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_CFLAGS = ["-O3", "-fPIC", "-shared"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def _build(name: str, link_flags=(), src_dir: str = _NATIVE_DIR) -> str:
    src = os.path.join(src_dir, name + ".c")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join([*_CFLAGS, *link_flags]).encode())
    so_path = os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["cc", *_CFLAGS, "-o", tmp, src, *link_flags]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {src} needs a C compiler ('cc'): {e}") from e
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"cc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, so_path)
    return so_path


@lru_cache(maxsize=None)
def jpeg_assemble_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build("jpeg_assemble"))
    lib.jpeg_assemble_3c.restype = _I64
    lib.jpeg_assemble_3c.argtypes = [_P, _P, _P, _P, _P, _P, _I64, _I32, _I32, _I64, _P, _I64]
    return lib


@lru_cache(maxsize=None)
def jpeg_scan_decode_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build("jpeg_scan_decode", ["-lpthread"]))
    lib.jpeg_scan_decode_mt.restype = _I64
    # data, size, tables, ncomp, comp_ntab, comp_nblocks, nmcu,
    # restart_interval, int16 outputs (array of pointers), threads
    lib.jpeg_scan_decode_mt.argtypes = [_P, _I64, _P, _I32, _P, _P, _I64, _I32, _P, ctypes.c_int]
    lib.jpeg_scan_decode_packed_mt.restype = _I64
    # ... as above, then lo, dc, exc_idx, exc_delta, exc_cap, &exc_count, threads
    lib.jpeg_scan_decode_packed_mt.argtypes = [_P, _I64, _P, _I32, _P, _P, _I64, _I32,
                                               _P, _P, _P, _P, _I64, _P, ctypes.c_int]
    return lib


@lru_cache(maxsize=None)
def ldgm_xor_lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(_build("ldgm_xor"))
    lib.ldgm_encode_xor.restype = None
    lib.ldgm_encode_xor.argtypes = [_P, _I64, _I64, _P, _I32, _I32, _P]
    return lib


@lru_cache(maxsize=None)
def udp_tx_lib() -> ctypes.CDLL:
    """sendmmsg batch sender (reference loader ``native.py:291``), from the
    port's copy ``csrc/udp_tx.c``, whose pacer never sleeps behind its
    schedule."""
    lib = ctypes.CDLL(_build("udp_tx", src_dir=_CSRC_DIR))
    lib.udp_send_packets.restype = _I64
    # fd, headers, header len, payload, offsets, sizes, npkt, pace_ns,
    # sockaddr, sockaddr len
    lib.udp_send_packets.argtypes = [ctypes.c_int, _P, _I32, _P, _P, _P, _I64, _I64,
                                     _P, ctypes.c_uint32]
    return lib


@lru_cache(maxsize=None)
def udp_rx_lib() -> ctypes.CDLL:
    """recvmmsg batch receiver (reference loader ``native.py:241``)."""
    lib = ctypes.CDLL(_build("udp_rx"))
    lib.udp_recv_batch.restype = ctypes.c_long
    # fd, buffer, row bytes, max packets, lengths, timeout in us
    lib.udp_recv_batch.argtypes = [ctypes.c_int, _P, ctypes.c_long, ctypes.c_int, _P, ctypes.c_long]
    return lib


@lru_cache(maxsize=None)
def video_rx_fast_lib() -> ctypes.CDLL:
    """The receiver's C depacketizer: recvmmsg, RTP and payload-header parse
    and the scatter into per-frame buffers (reference loader
    ``native.py:255``), from the port's copy ``csrc/video_rx_fast.c``,
    which grows the slots before it scatters a frame wider than them
    (ROADMAP F12)."""
    lib = ctypes.CDLL(_build("video_rx_fast", src_dir=_CSRC_DIR))
    lib.vrx_create.restype = _P
    lib.vrx_create.argtypes = [ctypes.c_long, ctypes.c_long]
    lib.vrx_destroy.argtypes = [_P]
    lib.vrx_set_buffer.argtypes = [_P, ctypes.c_int, _P, ctypes.c_long]
    lib.vrx_drain.restype = ctypes.c_long
    lib.vrx_drain.argtypes = [_P, ctypes.c_int, ctypes.c_long, ctypes.c_double,
                              _P, ctypes.c_long, _P, ctypes.c_int, _P, _P, _P]
    lib.vrx_poll.argtypes = [_P, _P]
    lib.vrx_nslots.restype = ctypes.c_int
    lib.vrx_nslots.argtypes = [_P]
    lib.vrx_slot_hdr.argtypes = [_P, ctypes.c_int, _P]
    lib.vrx_slot_intervals.restype = ctypes.c_long
    lib.vrx_slot_intervals.argtypes = [_P, ctypes.c_int, _P]
    lib.vrx_ssrc_stats.restype = ctypes.c_long
    lib.vrx_ssrc_stats.argtypes = [_P, ctypes.c_int, _P]
    lib.vrx_totals.argtypes = [_P, _P, _P]
    return lib


@lru_cache(maxsize=None)
def h264_assemble_lib() -> ctypes.CDLL:
    """H.264 slot-window assembler (reference loader ``native.py:123``)."""
    lib = ctypes.CDLL(_build("h264_assemble"))
    lib.h264_assemble.restype = ctypes.c_long
    # words, bit counts, rows, words per row, out, capacity
    lib.h264_assemble.argtypes = [_P, _P, ctypes.c_long, ctypes.c_long, _P, ctypes.c_long]
    return lib


@lru_cache(maxsize=None)
def h264_fast_lib() -> ctypes.CDLL:
    """The own H.264 decoder's C entropy and reconstruction stage, and the
    CAVLC -> CABAC transcoder (reference loader ``native.py:306``, the same
    argtypes)."""
    lib = ctypes.CDLL(_build("h264_entropy"))
    lib.h264fast_create.restype = _P
    # VLC table blob, its size, CABAC context init, rangeTabLPS,
    # transIdxLPS, 8x8 significance and last increments
    lib.h264fast_create.argtypes = [_P, ctypes.c_long, _P, _P, _P, _P, _P]
    lib.h264fast_flush_frame.restype = ctypes.c_int
    lib.h264fast_flush_frame.argtypes = [_P]
    lib.h264fast_decode_au.restype = ctypes.c_int
    lib.h264fast_decode_au.argtypes = [_P, _P, ctypes.c_long]
    lib.h264fast_dims.restype = ctypes.c_int
    lib.h264fast_dims.argtypes = [_P, _P, _P]
    lib.h264fast_get_planes.argtypes = [_P, _P, _P, _P]
    lib.h264fast_error.restype = ctypes.c_char_p
    lib.h264fast_error.argtypes = [_P]
    lib.h264fast_destroy.argtypes = [_P]
    return lib


@lru_cache(maxsize=None)
def j2k_t1_lib() -> ctypes.CDLL:
    """EBCOT Tier-1 block coder (MQ coder and coding passes) of the own JPEG
    2000 codec (reference loader ``native.py:217``, the same argtypes)."""
    lib = ctypes.CDLL(_build("j2k_t1"))
    lib.j2k_t1_encode_cblk.restype = ctypes.c_long
    # block, width, height, orientation, dropped planes, out, capacity,
    # state, (numbps, npasses)
    lib.j2k_t1_encode_cblk.argtypes = [_P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, _P, ctypes.c_long, _P, _P]
    lib.j2k_t1_decode_cblk.restype = ctypes.c_long
    # data, length, width, height, orientation, numbps, npasses, out, state
    lib.j2k_t1_decode_cblk.argtypes = [_P, ctypes.c_long, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P]
    return lib


_LAVC_LIBS = ["-lavcodec", "-lavformat", "-lavutil", "-lswscale"]
_LAVC_HEADERS = ("libavcodec/avcodec.h", "libavformat/avformat.h", "libswscale/swscale.h")


@lru_cache(maxsize=None)
def lavc_headers_present() -> bool:
    """Whether ``cc`` finds the FFmpeg headers the shim includes."""
    code = "".join(f"#include <{h}>\n" for h in _LAVC_HEADERS)
    try:
        res = subprocess.run(["cc", "-E", "-x", "c", "-o", os.devnull, "-"], input=code,
                             capture_output=True, text=True)
    except FileNotFoundError:
        return False
    return res.returncode == 0


@lru_cache(maxsize=None)
def lavc_shim_lib() -> ctypes.CDLL:
    """libavcodec / libavformat / libswscale shim (reference loader
    ``native.py:137``, the same argtypes, and ``lavc_dec_flush``).  Raises
    where the FFmpeg headers are absent or the build fails."""
    if not lavc_headers_present():
        raise RuntimeError("libavcodec is not available: cc finds no FFmpeg headers ("
                           + ", ".join(_LAVC_HEADERS) + ")")
    lib = ctypes.CDLL(_build("lavc_shim", _LAVC_LIBS, _CSRC_DIR))
    lib.lavc_version.restype = ctypes.c_int
    lib.lavc_have.restype = ctypes.c_int
    lib.lavc_have.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.lavc_list.restype = ctypes.c_long
    lib.lavc_list.argtypes = [ctypes.c_int, _P, ctypes.c_long]
    lib.lavc_enc_open.restype = _P
    # codec name, width, height, input format, fps, bitrate, options
    lib.lavc_enc_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, ctypes.c_long, ctypes.c_char_p]
    lib.lavc_enc_frame.restype = ctypes.c_long
    # handle, data, linesize, force a keyframe, out, capacity, &keyframe
    lib.lavc_enc_frame.argtypes = [_P, _P, ctypes.c_long, ctypes.c_int, _P, ctypes.c_long, _P]
    lib.lavc_enc_close.argtypes = [_P]
    lib.lavc_enc_extradata.restype = ctypes.c_long
    lib.lavc_enc_extradata.argtypes = [_P, _P, ctypes.c_long]
    lib.lavc_dec_open.restype = _P
    lib.lavc_dec_open.argtypes = [ctypes.c_char_p]
    lib.lavc_dec_open2.restype = _P
    # codec name, extradata, its size, width, height
    lib.lavc_dec_open2.argtypes = [ctypes.c_char_p, _P, ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.lavc_dec_packet.restype = ctypes.c_long
    # handle, data, size, output format, out, capacity, (width, height)
    lib.lavc_dec_packet.argtypes = [_P, _P, ctypes.c_long, ctypes.c_int, _P, ctypes.c_long, _P]
    lib.lavc_dec_flush.restype = ctypes.c_long
    lib.lavc_dec_flush.argtypes = [_P, ctypes.c_int, _P, ctypes.c_long, _P]
    lib.lavc_dec_close.argtypes = [_P]
    lib.lavc_aenc_open.restype = _P
    lib.lavc_aenc_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_char_p]
    lib.lavc_aenc_frame_size.restype = ctypes.c_int
    lib.lavc_aenc_frame_size.argtypes = [_P]
    lib.lavc_aenc_encode.restype = ctypes.c_long
    lib.lavc_aenc_encode.argtypes = [_P, _P, ctypes.c_int, _P, ctypes.c_long]
    lib.lavc_adec_open.restype = _P
    lib.lavc_adec_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.lavc_adec_decode.restype = ctypes.c_long
    lib.lavc_adec_decode.argtypes = [_P, _P, ctypes.c_long, _P, ctypes.c_long]
    lib.lavc_acod_close.argtypes = [_P]
    lib.lavf_open.restype = _P
    lib.lavf_open.argtypes = [ctypes.c_char_p]
    lib.lavf_info.argtypes = [_P, _P, _P, _P]
    lib.lavf_read_frame.restype = ctypes.c_long
    lib.lavf_read_frame.argtypes = [_P, ctypes.c_int, _P, ctypes.c_long]
    lib.lavf_seek_start.argtypes = [_P]
    lib.lavf_close.argtypes = [_P]
    lib.lavf_mux_open.restype = _P
    # url, codec id, width, height, fps, extradata, its size
    lib.lavf_mux_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int, _P, ctypes.c_long]
    lib.lavf_mux_write.restype = ctypes.c_int
    lib.lavf_mux_write.argtypes = [_P, _P, ctypes.c_long, ctypes.c_int]
    lib.lavf_mux_close.argtypes = [_P]
    return lib
