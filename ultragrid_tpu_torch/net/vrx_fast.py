"""Fast-path video receive: C depacketizer + frame-granularity gating.

The port's copy of ``ultragrid_tpu/net/vrx_fast.py``, over the port's own
copy of the C layer, ``csrc/video_rx_fast.c`` (its loader raises if it
cannot be built).  Slot buffers are host memory; a display-owned
framebuffer on the card gets each frame by one upload.

A frame wider than the slots (they start at 256 KiB) makes the C layer hold
its receive batch at the frame's first datagram; :meth:`FastVideoRx.drain`
grows the free slots and calls again, so the frame lands whole.  The
reference hands that batch back and grows the slots after it, so the first
such frame shows zeros where the batch's datagrams went (ROADMAP F12,
repaired here).

Wraps csrc/video_rx_fast.c — recvmmsg, RTP parse, UltraGrid payload
header parse and payload scatter into per-frame reassembly buffers all
run in C (the per-packet work the reference also keeps in C/C++:
udp_reader net_udp.c:163-187, pbuf_insert pbuf.c:438, the LINE_DECODER
copy video_decoders.cpp:1707-1796).  Python sees only frame-granularity
events: playout gating, frame construction and FEC job handoff are
O(frames), not O(packets), so a single core sustains the 4K60
uncompressed wire rate (~122k pkts/s).

Packets the C layer does not understand (encrypted PTs, RFC 2435/6184
standards payloads, CSRC/extension headers) are handed back verbatim
and flow through the ordinary pbuf path.  RFC 3550 reception statistics
are accounted ONCE, in C, for every valid RTP packet; they are merged
into the RTCP session just before each report is built.

The hand-back buffer holds a whole recvmmsg batch (``VRX_BATCH``, 256
datagrams).  The reference's holds 64, and the C layer drops the slow-path
datagrams of a batch beyond that without a word: a standards-mode receiver
that falls one or two 1080p frames behind loses packets of every frame
after (ROADMAP F11, repaired here).
"""

from __future__ import annotations

import ctypes
import time
from typing import Callable, List, Optional

import numpy as np

from ultragrid_tpu_torch.native import video_rx_fast_lib
from ultragrid_tpu_torch.net import rtp_types as rt
from ultragrid_tpu_torch.net.rtcp import SourceStats
from ultragrid_tpu_torch.net.rtp import RTP_HDR_LEN, RTP_MAX_PACKET_LEN, RtpPacket
from ultragrid_tpu_torch.net.video_rx import (
    MAX_FRAME_LEN,
    FecJob,
    VideoRxState,
    fill_tile,
    host_view,
    tile_nbytes,
)
from ultragrid_tpu_torch.types import VideoFrame
from ultragrid_tpu_torch.utils import profiler
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("vrx_fast")

META_WORDS = 12
VRX_BATCH = 256  # datagrams per recvmmsg batch (csrc/video_rx_fast.c)
STUCK_TIMEOUT = 1.0  # ref: pbuf.c:599 — force-decode a stuck frame

_FAST_PTS = (rt.PT_VIDEO, rt.PT_VIDEO_LDGM, rt.PT_VIDEO_RS)


def _flat_view(frame) -> Optional[np.ndarray]:
    """Writable flat host view of a display frame's buffer, or None (no
    frame, or a buffer on the card)."""
    return None if frame is None else host_view(frame.tiles[0])


class _PendingFrame:
    __slots__ = ("ssrc", "ts", "slots", "gens", "arrival", "taken")

    def __init__(self, ssrc: int, ts: int, arrival: float):
        self.ssrc = ssrc
        self.ts = ts
        self.slots: dict = {}  # substream -> slot index
        self.gens: dict = {}   # slot index -> gen (guards against reuse)
        self.arrival = arrival
        self.taken = False


class FastVideoRx:
    """One instance per receiving video RtpSession."""

    def __init__(self, session, rx_state: VideoRxState,
                 framebuffer_provider: Optional[Callable] = None,
                 initial_cap: int = 1 << 18, stamp_last_arrival: bool = False):
        lib = video_rx_fast_lib()
        self.lib = lib
        self.session = session
        self.rx_state = rx_state
        self.framebuffer_provider = framebuffer_provider
        self.state = lib.vrx_create(MAX_FRAME_LEN, RTP_MAX_PACKET_LEN)
        if not self.state:
            raise RuntimeError("vrx_create failed")
        self.nslots = int(lib.vrx_nslots(self.state))
        self._meta = np.zeros(self.nslots * META_WORDS, np.uint64)
        self._hdr_buf = (ctypes.c_ubyte * 24)()
        self._iv_buf = np.zeros(2 * 64, np.uint64)
        # slot buffers: Python-owned numpy arrays; may later be swapped
        # for display-owned framebuffers (LINE_DECODER zero-copy)
        self._slot_buf: List[np.ndarray] = []
        self._slot_fb: List[Optional[object]] = [None] * self.nslots
        self._fb_on_host = True  # False once the display hands out frames on the card
        self._cap = initial_cap
        for i in range(self.nslots):
            buf = np.empty(self._cap, np.uint8)
            self._slot_buf.append(buf)
            lib.vrx_set_buffer(self.state, i, buf.ctypes.data, buf.size)
        # overflow scratch (reused; packets are copied out when parsed),
        # room for every datagram of a batch (ROADMAP F11)
        self._ovf = np.empty((VRX_BATCH, RTP_MAX_PACKET_LEN), np.uint8)
        self._ovf_lens = np.empty(VRX_BATCH, np.int32)
        self._pending: dict = {}  # (ssrc, ts) -> _PendingFrame
        # with ``stamp_last_arrival``: (ssrc, ts) -> the arrival stamp of the
        # recvmmsg batch that brought the frame's latest datagram, handed on
        # as the frame's ``callbacks["last_arrival"]`` (the last packet ->
        # display latency of tools/bench_receiver.py); (gen, slot) -> the
        # slot's datagram count at the last look
        self._last_arrival: Optional[dict] = {} if stamp_last_arrival else None
        self._pkts_seen: dict = {}
        self._rtcp_snapshot: list = []
        self._stats_out = np.zeros(8, np.uint64)
        if session.rtcp is not None:
            session.rtcp.pre_report_hook = self._apply_rtcp_snapshot

    def close(self) -> None:
        if self.state:
            self.lib.vrx_destroy(self.state)
            self.state = None

    # -- packet drain ------------------------------------------------------

    def drain(self, timeout: float = 0.0001,
              max_batches: int = 8) -> List[RtpPacket]:
        """Drain the socket (one or more recvmmsg batches).  Returns the
        slow-path packets for pbuf insertion; fast-PT packets have already
        been scattered into slot buffers in C."""
        lib = self.lib
        overflow: List[RtpPacket] = []
        n_ovf = ctypes.c_int()
        flags = ctypes.c_int()
        need_cap = ctypes.c_long()
        fd = self.session.sock.fileno()
        for _ in range(max_batches):
            now = time.monotonic()
            n = lib.vrx_drain(
                self.state, fd, int(timeout * 1e6), ctypes.c_double(now),
                self._ovf.ctypes.data, self._ovf.shape[1],
                self._ovf_lens.ctypes.data, self._ovf.shape[0],
                ctypes.byref(n_ovf), ctypes.byref(flags),
                ctypes.byref(need_cap),
            )
            timeout = 0.0  # only the first batch may wait
            if n <= 0:
                break
            if self._last_arrival is not None:
                self._stamp_arrivals(now)
            if n_ovf.value:
                self._parse_overflow(overflow, n_ovf.value, now)
            if flags.value & 2 and need_cap.value:  # NEED_CAP: the C layer holds the batch
                self._grow(int(need_cap.value))
                continue  # the next call scatters the held datagrams into the grown slots
            if n < 200:  # batch not full: socket drained
                break
        # refresh session counters (control stats lines)
        pk = ctypes.c_uint64()
        by = ctypes.c_uint64()
        lib.vrx_totals(self.state, ctypes.byref(pk), ctypes.byref(by))
        self.session.packets_received = int(pk.value)
        self.session.bytes_received = int(by.value)
        self._snapshot_rtcp()
        return overflow

    def _stamp_arrivals(self, now: float) -> None:
        """Stamp ``now`` on every frame whose slot took datagrams in the
        batch just drained (its datagram count moved)."""
        self.lib.vrx_poll(self.state, self._meta.ctypes.data)
        meta = self._meta.reshape(self.nslots, META_WORDS)
        for i in range(self.nslots):
            if not int(meta[i, 0]):
                continue
            key, pkts = (int(meta[i, 1]), i), int(meta[i, 8])
            if self._pkts_seen.get(key) != pkts:
                self._pkts_seen[key] = pkts
                self._last_arrival[(int(meta[i, 2]), int(meta[i, 3]))] = now

    def _parse_overflow(self, out: List[RtpPacket], n: int,
                        arrival: float) -> None:
        """Parse slow-path datagrams into RtpPackets.  RTCP reception stats
        were already accounted in C — do NOT feed session.rtcp here."""
        buf = self._ovf
        for i in range(n):
            data = bytes(buf[i, : self._ovf_lens[i]])
            if len(data) < RTP_HDR_LEN or (data[0] >> 6) != 2:
                continue
            b0, b1 = data[0], data[1]
            payload_start = RTP_HDR_LEN + (b0 & 0xF) * 4
            if (b0 >> 4) & 1:  # header extension
                if len(data) < payload_start + 4:
                    continue
                xlen = int.from_bytes(data[payload_start + 2: payload_start + 4],
                                      "big")
                payload_start += 4 + xlen * 4
            out.append(RtpPacket(
                pt=b1 & 0x7F,
                seq=int.from_bytes(data[2:4], "big"),
                ts=int.from_bytes(data[4:8], "big"),
                ssrc=int.from_bytes(data[8:12], "big"),
                m=bool(b1 & 0x80),
                payload=data[payload_start:],
                arrival=arrival,
            ))

    def _grow(self, need: int) -> None:
        """A frame larger than the slot capacity appeared: re-buffer every
        FREE slot at the new size (active slots keep finishing in place)."""
        cap = max(need, self._cap)
        self._cap = cap
        self.lib.vrx_poll(self.state, self._meta.ctypes.data)
        meta = self._meta.reshape(self.nslots, META_WORDS)
        for i in range(self.nslots):
            if not int(meta[i, 0]) and (self._slot_fb[i] is not None
                                        or self._slot_buf[i].size < cap):
                buf = np.empty(cap, np.uint8)
                self._slot_buf[i] = buf
                self._slot_fb[i] = None
                self.lib.vrx_set_buffer(self.state, i, buf.ctypes.data,
                                        buf.size)

    # -- RTCP statistics merge ----------------------------------------------

    def _snapshot_rtcp(self) -> None:
        snap = []
        out = self._stats_out
        for idx in range(16):
            if not self.lib.vrx_ssrc_stats(self.state, idx, out.ctypes.data):
                continue
            jitter = float(out[4:5].view(np.float64)[0])
            snap.append((int(out[0]), int(out[1]), int(out[2]),
                         int(out[3]), jitter))
        self._rtcp_snapshot = snap

    def _apply_rtcp_snapshot(self, rtcp) -> None:
        """pre_report_hook: merge the C-side RFC 3550 reception stats into
        the RTCP session's SourceStats just before a report is built."""
        for ssrc, received, base_seq, ext_max, jitter in self._rtcp_snapshot:
            src = rtcp.sources.get(ssrc)
            if src is None:
                src = rtcp.sources[ssrc] = SourceStats(base_seq)
            src.base_seq = base_seq
            src.max_seq = ext_max & 0xFFFF
            src.cycles = ext_max & ~0xFFFF
            src.received = received
            src.jitter = jitter

    # -- frame-granularity gating -------------------------------------------

    def poll(self, now: float, playout_delay: float) -> list:
        """Emit frames whose playout time has passed (complete) or that are
        stuck past the escape window (pbuf.c:577-608 semantics at frame
        granularity).  Returns VideoFrame / FecJob objects, oldest first."""
        self.lib.vrx_poll(self.state, self._meta.ctypes.data)
        meta = self._meta.reshape(self.nslots, META_WORDS)
        pending = self._pending
        for i in range(self.nslots):
            if not int(meta[i, 0]):
                continue
            ssrc, ts = int(meta[i, 2]), int(meta[i, 3])
            key = (ssrc, ts)
            pf = pending.get(key)
            if pf is None:
                pf = pending[key] = _PendingFrame(
                    ssrc, ts, float(meta[i, 9:10].view(np.float64)[0]))
            pf.slots[int(meta[i, 4])] = i
            pf.gens[i] = int(meta[i, 1])
        ready = []
        for key, pf in sorted(pending.items(), key=lambda kv: kv[1].arrival):
            complete = any(int(meta[s, 6]) for s in pf.slots.values())
            deadline = pf.arrival + playout_delay
            if now <= deadline:
                continue
            if not complete and now <= deadline + STUCK_TIMEOUT:
                continue
            # the frame's wait in the playout buffer from its first
            # datagram, then its reassembly: at most one record each a frame
            profiler.interval("rx.playout", int(pf.arrival * 1e9), pf.ts)
            t_take = time.monotonic_ns()
            out = self._take(pf, meta)
            del pending[key]
            if out is not None:
                profiler.interval("rx.reassemble", t_take, pf.ts)
                ready.append(out)
        return ready

    def _take(self, pf: _PendingFrame, meta) -> Optional[object]:
        lib = self.lib
        slots = [pf.slots[sub] for sub in sorted(pf.slots)]
        # guard: a slot may have been re-activated for a different frame
        slots = [s for s in slots
                 if int(meta[s, 1]) == pf.gens.get(s)
                 and int(meta[s, 2]) == pf.ssrc and int(meta[s, 3]) == pf.ts]
        if not slots:
            return None
        pt = int(meta[slots[0], 5])
        allow_fb = pt == rt.PT_VIDEO and len(slots) == 1
        last = None
        if self._last_arrival is not None:
            last = self._last_arrival.pop((pf.ssrc, pf.ts), pf.arrival)
            for s in slots:
                self._pkts_seen.pop((pf.gens[s], s), None)
        try:
            if pt == rt.PT_VIDEO:
                frame = self._take_video(pf, slots, meta)
                if last is not None:
                    frame.callbacks["last_arrival"] = last
                return frame
            return self._take_fec(pf, slots[0], meta,
                                  "ldgm" if pt == rt.PT_VIDEO_LDGM else "rs")
        finally:
            for s in slots:
                self._rebuffer(s, allow_fb)

    def _zero_gaps(self, slot: int, buf: np.ndarray, frame_len: int) -> int:
        """Zero every byte of buf[:frame_len] not covered by a received
        interval (slot buffers are recycled, so holes would otherwise show
        stale bytes); returns covered byte count."""
        n_iv = int(self.lib.vrx_slot_intervals(self.state, slot,
                                               self._iv_buf.ctypes.data))
        pos = 0
        covered = 0
        for k in range(n_iv):
            a = int(self._iv_buf[2 * k])
            b = min(int(self._iv_buf[2 * k + 1]), frame_len)
            if a > pos:
                buf[pos:a] = 0
            covered += max(0, b - a)
            pos = max(pos, b)
        if pos < frame_len:
            buf[pos:frame_len] = 0
        return covered

    def _take_video(self, pf: _PendingFrame, slots: list, meta):
        st = self.rx_state
        frames = {}
        descs = {}
        complete = True
        for s in slots:
            frame_len = int(meta[s, 7])
            sub = int(meta[s, 4])
            lib_hdr = self._hdr_buf
            self.lib.vrx_slot_hdr(self.state, s, lib_hdr)
            _, _, _, _, desc = rt.parse_video_header(bytes(lib_hdr))
            buf = self._slot_buf[s][:frame_len]
            covered = self._zero_gaps(s, buf, frame_len)
            if covered < frame_len:
                complete = False
            frames[sub] = (s, buf)
            descs[sub] = desc
        if complete:
            st.frames_ok += 1
        else:
            st.frames_ok += 1
            st.frames_missing_data += 1
        if len(frames) == 1:
            (sub,) = frames
            s, buf = frames[sub]
            desc = descs[sub]
            frame = self._present_single(s, buf, desc)
        else:
            desc0 = descs[min(descs)]
            tiles = [st._wrap(frames[sub][1], descs[sub]).data
                     for sub in sorted(frames)]
            frame = VideoFrame(desc0.with_(tile_count=len(tiles)), tiles)
        frame.callbacks["ssrc"] = pf.ssrc
        frame.timestamp = (pf.ts & 0xFFFFFFFF) / 90000.0
        return frame

    def _present_single(self, slot: int, buf: np.ndarray, desc):
        """Single-substream video frame: preserve the LINE_DECODER
        display-owned zero-copy property.  If this slot's buffer IS a
        display framebuffer of the right description, emit that frame
        object (identity).  Otherwise, when the display takes the codec
        natively, copy once into a display frame — and swap the slot's
        buffer for a display framebuffer so subsequent frames on this
        slot are zero-copy.  A display framebuffer on the card takes the
        frame in one upload."""
        fb = self._slot_fb[slot]
        if fb is not None and fb.desc == desc:
            fb.callbacks["display_owned"] = True
            self._slot_fb[slot] = None  # ownership moves to the display
            return fb
        provider = self.framebuffer_provider
        if provider is not None:
            out = provider(desc)
            if out is not None and tile_nbytes(out.tiles[0]) >= buf.size:
                flat = _flat_view(out)
                if flat is not None:
                    flat[: buf.size] = buf
                else:
                    fill_tile(out.tiles[0], buf)
                out.callbacks["display_owned"] = True
                return out
        return self.rx_state._wrap(buf, desc)

    def _rebuffer(self, slot: int, allow_fb: bool) -> None:
        """Detach the emitted buffer from the slot and attach a fresh one.
        Prefer a display-owned framebuffer (zero-copy steady state) when
        the provider accepts the stream's description and its frames are
        host memory; a display on the card is asked once, and then its
        frames are filled by upload in :meth:`_present_single`."""
        fb = None
        provider = self.framebuffer_provider
        if allow_fb and provider is not None and self._fb_on_host:
            self.lib.vrx_slot_hdr(self.state, slot, self._hdr_buf)
            try:
                _, _, _, frame_len, desc = rt.parse_video_header(
                    bytes(self._hdr_buf))
            except Exception:  # noqa: BLE001 — malformed header bytes
                frame_len, desc = 0, None
            if desc is not None and 0 < frame_len <= MAX_FRAME_LEN:
                try:
                    out = provider(desc)
                except Exception:  # noqa: BLE001
                    out = None
                flat = _flat_view(out)
                if flat is not None and flat.size >= frame_len:
                    fb = (out, flat)
                elif out is not None and flat is None:
                    self._fb_on_host = False
        if fb is not None:
            frame_obj, flat = fb
            self._slot_fb[slot] = frame_obj
            self._slot_buf[slot] = flat
            self.lib.vrx_set_buffer(self.state, slot, flat.ctypes.data,
                                    flat.size)
        else:
            buf = np.empty(self._cap, np.uint8)
            self._slot_fb[slot] = None
            self._slot_buf[slot] = buf
            self.lib.vrx_set_buffer(self.state, slot, buf.ctypes.data,
                                    buf.size)

    def _take_fec(self, pf: _PendingFrame, slot: int, meta, kind: str):
        frame_len = int(meta[slot, 7])
        self.lib.vrx_slot_hdr(self.state, slot, self._hdr_buf)
        _, _, _, _, k, m, c, seed = rt.parse_fec_header(bytes(self._hdr_buf))
        # the slot gets a FRESH buffer in _rebuffer, so the emitted job owns
        # this one exclusively — no copy
        buf = self._slot_buf[slot][:frame_len]
        got = np.zeros(frame_len, bool)
        n_iv = int(self.lib.vrx_slot_intervals(self.state, slot,
                                               self._iv_buf.ctypes.data))
        for i in range(n_iv):
            a = int(self._iv_buf[2 * i])
            b = min(int(self._iv_buf[2 * i + 1]), frame_len)
            got[a:b] = True
        return FecJob(kind, buf, got, (frame_len, k, m, c, seed),
                      ssrc=pf.ssrc, rtp_ts=pf.ts)
