"""Playout buffer: per-SSRC ordered frame buffers keyed by RTP timestamp.

The port's copy of ``ultragrid_tpu/net/pbuf.py`` (jax-free).

ref: src/rtp/pbuf.c — a frame is decoded only once the playout delay has
elapsed (default 32 ms, pbuf.c:191) AND it is complete; it is COMPLETE when
its M-bit packet arrived or a packet of a NEWER frame was inserted
(pbuf.c:466) or it has been stuck for 1 s past its playout time
(pbuf.c:599-600).  Frames expire after a further playout delay.  Per-stream
expected/received/duplicate/reorder statistics mirror pbuf_process_stats
(pbuf.c:351-420).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from ultragrid_tpu_torch.net.rtp import RtpPacket
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("pbuf")

DEFAULT_PLAYOUT_DELAY = 0.032  # ref: pbuf.c:191
COMPLETE_TIMEOUT = 1.0  # ref: pbuf.c:599 — force-complete a stuck frame


class PbufNode:
    """One frame's worth of packets (same RTP TS)."""

    __slots__ = ("ts", "packets", "arrival", "playout_time", "deletion_time",
                 "decoded", "completed", "mbit_seen")

    def __init__(self, ts: int, arrival: float, playout_delay: float):
        self.ts = ts
        self.packets: List[RtpPacket] = []
        self.arrival = arrival
        self.playout_time = arrival + playout_delay
        self.deletion_time = self.playout_time + playout_delay
        self.decoded = False
        self.completed = False
        self.mbit_seen = False

    def insert_packet(self, pkt: RtpPacket) -> None:
        """Keep packets seq-ordered (ref: add_coded_unit, pbuf.c:230-283)."""
        self.packets.append(pkt)
        if pkt.m:
            self.mbit_seen = True

    @property
    def is_complete(self) -> bool:
        """ref: frame_complete, pbuf.c:558-569."""
        return self.mbit_seen or self.completed


class _SsrcStats:
    """Per-SSRC packet accounting (ref: pbuf_process_stats, pbuf.c:351)."""

    __slots__ = ("last_seq", "received", "expected", "dups", "out_of_order",
                 "max_oo_dist", "_seen")

    def __init__(self) -> None:
        self.last_seq: Optional[int] = None
        self.received = 0
        self.expected = 0
        self.dups = 0
        self.out_of_order = 0
        self.max_oo_dist = 0
        self._seen: set = set()

    def process(self, seq: int) -> None:
        self.received += 1
        if self.last_seq is None:
            self.last_seq = seq
            self.expected += 1
            self._seen.add(seq)
            return
        dist = (seq - self.last_seq) & 0xFFFF
        if dist == 0 or seq in self._seen:
            self.dups += 1
        elif dist < 0x8000:
            # forward: every skipped seq was expected but (so far) not seen
            self.expected += dist
        else:
            # reorder: arrived after a later seq
            back = 0x10000 - dist
            self.out_of_order += 1
            self.max_oo_dist = max(self.max_oo_dist, back)
        self._seen.add(seq)
        if len(self._seen) > 4096:  # bound memory on long streams
            self._seen.clear()
        if dist < 0x8000 and dist:
            self.last_seq = seq


class PlayoutBuffer:
    """Per-participant frame buffers keyed by (SSRC, RTP TS)
    (ref: per-SSRC pbufs walked by the receiver, ultragrid_rtp.c:483)."""

    def __init__(self, playout_delay: float = DEFAULT_PLAYOUT_DELAY):
        self.playout_delay = playout_delay
        self.frames: Dict[tuple, PbufNode] = {}  # keyed by (ssrc, ts)
        self.order: List[tuple] = []
        self.stats_received = 0
        self.stats: Dict[int, _SsrcStats] = {}
        self._last_node: Dict[int, PbufNode] = {}

    def insert(self, pkt: RtpPacket) -> None:
        """ref: pbuf_insert, pbuf.c:438."""
        self.stats_received += 1
        self.stats.setdefault(pkt.ssrc, _SsrcStats()).process(pkt.seq)
        key = (pkt.ssrc, pkt.ts)
        node = self.frames.get(key)
        if node is None:
            node = PbufNode(pkt.ts, pkt.arrival, self.playout_delay)
            self.frames[key] = node
            self.order.append(key)
            # a packet of a NEWER frame completes the previous one
            # (ref: pbuf.c:466)
            prev = self._last_node.get(pkt.ssrc)
            if prev is not None and ((pkt.ts - prev.ts) & 0xFFFFFFFF) < 0x80000000:
                prev.completed = True
            self._last_node[pkt.ssrc] = node
        node.insert_packet(pkt)

    def received_stats(self, ssrc: Optional[int] = None) -> Tuple[int, int]:
        """(received, expected) packet counts (ref: struct pbuf_stats)."""
        if ssrc is not None:
            st = self.stats.get(ssrc)
            return (st.received, st.expected) if st else (0, 0)
        return (
            sum(s.received for s in self.stats.values()),
            sum(s.expected for s in self.stats.values()),
        )

    def decode(self, now: float, decode_cb: Callable[[PbufNode], bool]) -> bool:
        """Decode the first complete frame past its playout time
        (ref: pbuf_decode, pbuf.c:577-608).  The playout delay is honored
        even for early-complete frames — it is the reorder window that lets
        stragglers (e.g. a retransmitted packet arriving after the M-bit)
        still make it into the frame."""
        for key in list(self.order):
            node = self.frames.get(key)
            if node is None or node.decoded:
                continue
            if now <= node.playout_time:
                continue
            if node.is_complete:
                ok = decode_cb(node)
                node.decoded = True
                return ok
            if now > node.playout_time + COMPLETE_TIMEOUT:
                node.completed = True  # stuck: give up waiting for more data
        return False

    def remove_old(self, now: float) -> None:
        """ref: pbuf_remove, expire frames after playout + delay."""
        keep = []
        for key in self.order:
            node = self.frames.get(key)
            if node is not None and now >= node.deletion_time and node.is_complete:
                del self.frames[key]
            elif node is not None and now >= node.deletion_time + COMPLETE_TIMEOUT:
                del self.frames[key]  # incomplete frames go after the escape window
            else:
                keep.append(key)
        self.order = keep
