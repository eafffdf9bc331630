"""Faults planted in the timed path for ``test_ugbench_session.py``; each
must turn ``correct`` false, or refuse the run.  The receiver's are applied
in the second process through ``run_cell(child_setup=...)``."""

import sys
import types

import numpy as np


def stale_sender():
    """The compress step returns its first output again and again."""
    from ultragrid_tpu_torch.modules.video_compress import JpegCompress

    orig = JpegCompress.compress
    first = {}

    def compress(self, frame):
        out = orig(self, frame)
        first.setdefault("data", out.data)
        out.tiles[0] = first["data"]
        return out

    JpegCompress.compress = compress


def half_packets():
    """The packetizer covers half of each frame's buffer."""
    from ultragrid_tpu_torch.net import transmit

    orig = transmit.get_packet_sizes

    def sizes(data_len, *a, **kw):
        got = orig(data_len, *a, **kw)
        return got[: max(1, len(got) // 2)]

    transmit.get_packet_sizes = sizes


def altered_answer():
    """One byte in the middle of each file's scan is altered where the
    encoder produces it."""
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder

    orig = JpegEncoder.encode

    def encode(self, frame, device="cuda"):
        data = np.array(orig(self, frame, device), copy=True)
        data[data.size * 2 // 3] ^= 0x5A
        return data

    JpegEncoder.encode = encode


def stale_receiver():
    """The receiver's decode returns its first picture again and again."""
    from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress

    orig = JpegDecompress.decompress
    first = {}

    def decompress(self, frame, out_codec):
        out = orig(self, frame, out_codec)
        first.setdefault("data", out.tiles[0])
        out.tiles[0] = first["data"]
        return out

    JpegDecompress.decompress = decompress


def receiver_loads_jax():
    """The receiver's process loads a module named ``jax``."""
    sys.modules.setdefault("jax", types.ModuleType("jax"))


def host_without_cap_net_admin():
    """The receiver's host cannot force a socket's buffer past its limit."""
    import socket

    if hasattr(socket, "SO_RCVBUFFORCE"):
        del socket.SO_RCVBUFFORCE
