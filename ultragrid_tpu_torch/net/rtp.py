"""Minimal RTP session over UDP (RFC 3550 data path + basic RTCP).

The port's copy of ``ultragrid_tpu/net/rtp.py`` (jax-free).  Video is sent
in batches through the C helper ``csrc/udp_tx.c``; audio, a few
packets every 40 ms, one packet at a time from the caller's thread
(:meth:`RtpSession.send_data_hdr`, where the reference hands each packet to
a send thread: the same bytes in the same order).  Batch receives go through
``native/udp_rx.c`` (the port's loaders raise if they cannot be built; there
is no Python-socket stand-in for them).  Extra unicast destinations (the
RTSP clients that PLAY a ``--rtsp`` sender) get a copy of every packet, one
``sendto`` each, as in the reference.

Host-side analogue of the reference's src/rtp/rtp.c + net_udp.c: dual-role
session bound to rx_port, sending to (addr, tx_port); receive uses a
blocking socket with timeout (dedicated recv thread mode optional).
"""

from __future__ import annotations

import queue
import random
import socket
import struct
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.native import udp_rx_lib, udp_tx_lib
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("rtp")

RTP_VERSION = 2
RTP_HDR_LEN = 12
RTP_MAX_PACKET_LEN = 9200


# -- address helpers (ref: dual-stack + multicast setup in net_udp.c:163-187,
#    udp_addr_valid/udp_init_if 1026-1131) ------------------------------------


def resolve_addr(addr: Optional[str], force_ip_version: int = 0) -> Tuple[int, Optional[str]]:
    """Resolve ``addr`` to (family, numeric-ip).  ``force_ip_version`` of
    4 or 6 restricts resolution (ref: '-4'/'-6' options, net_udp.c)."""
    if not addr:
        return (socket.AF_INET6 if force_ip_version == 6 else socket.AF_INET), None
    fam = {4: socket.AF_INET, 6: socket.AF_INET6}.get(force_ip_version, socket.AF_UNSPEC)
    infos = socket.getaddrinfo(addr, None, fam, socket.SOCK_DGRAM)
    # prefer IPv4 on unspec lookups (reference resolves the same name for
    # whichever family the socket got; we pick one deterministically)
    infos.sort(key=lambda i: 0 if i[0] == socket.AF_INET else 1)
    family, _, _, _, sa = infos[0]
    return family, sa[0]


def is_multicast(family: int, ip: Optional[str]) -> bool:
    """ref: IN_MULTICAST/IN6_IS_ADDR_MULTICAST checks in net_udp.c."""
    if not ip:
        return False
    if family == socket.AF_INET:
        try:
            first = int(ip.split(".", 1)[0])
        except ValueError:
            return False
        return 224 <= first <= 239
    try:
        b = socket.inet_pton(socket.AF_INET6, ip)
    except OSError:
        return False
    return b[0] == 0xFF


def pack_sockaddr(family: int, ip: str, port: int) -> bytes:
    """Build a native struct sockaddr_in / sockaddr_in6 (Linux layout:
    little-endian sa_family, network-order port) for the C sendmmsg path."""
    fam_le = struct.pack("<H", family)
    port_be = struct.pack("!H", port)
    if family == socket.AF_INET:
        return fam_le + port_be + socket.inet_aton(ip) + bytes(8)
    return (fam_le + port_be + bytes(4)  # flowinfo
            + socket.inet_pton(socket.AF_INET6, ip) + bytes(4))  # scope 0


class RtpPacket:
    __slots__ = ("pt", "seq", "ts", "ssrc", "m", "payload", "arrival", "_decrypted")

    def __init__(self, pt, seq, ts, ssrc, m, payload, arrival):
        self.pt = pt
        self.seq = seq
        self.ts = ts
        self.ssrc = ssrc
        self.m = m
        self.payload = payload
        self.arrival = arrival


class RtpSession:
    """UDP RTP session (ref: rtp_init_if / rtp_send_data_hdr / rtp_recv_r)."""

    def __init__(
        self,
        addr: Optional[str] = None,
        rx_port: int = 5004,
        tx_port: int = 5004,
        ttl: int = 255,
        recv_buf: int = 4 * 1024 * 1024,
        send_buf: int = 4 * 1024 * 1024,
        mtu: int = 1500,
        rtcp: bool = False,
        force_ip_version: int = 0,
        mcast_if: Optional[str] = None,
    ):
        self.addr = addr
        self.rx_port = rx_port
        self.tx_port = tx_port
        self.ttl = ttl
        self.ssrc = random.getrandbits(32)
        self.seq = random.getrandbits(16)
        # dual-stack: family follows the resolved destination address
        # (ref: net_udp.c udp_init_if resolves then sockets per family)
        self.family, ip = resolve_addr(addr, force_ip_version)
        self.multicast = is_multicast(self.family, ip)
        self.sock = socket.socket(self.family, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            # 4-6 MB socket buffers (ref: doc/PERFORMANCE-TUNING.md:18-22)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, recv_buf)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, send_buf)
        except OSError:
            pass
        if self.multicast:
            # receive the group + loop locally so single-host sessions work
            # (ref: udp_join_mcast_grp / IP_MULTICAST_LOOP, net_udp.c)
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            except (OSError, AttributeError):
                pass
            if self.family == socket.AF_INET:
                # --mcast-if binds group membership + egress to an interface
                # (ref: OPT_MCAST_IF, main.cpp:892 + net_udp.c)
                ifaddr = socket.inet_aton(mcast_if) if mcast_if else socket.inet_aton("0.0.0.0")
                mreq = socket.inet_aton(ip) + ifaddr
                self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
                self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
                self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL,
                                     min(max(ttl, 0), 255))
                if mcast_if:
                    self.sock.setsockopt(socket.IPPROTO_IP,
                                         socket.IP_MULTICAST_IF, ifaddr)
            else:
                mreq = socket.inet_pton(socket.AF_INET6, ip) + struct.pack("@I", 0)
                self.sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_JOIN_GROUP, mreq)
                self.sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_LOOP, 1)
                self.sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_HOPS,
                                     min(max(ttl, 0), 255))
        elif ttl and ttl != 255:
            # honor unicast TTL when explicitly narrowed (ref: IP_TTL setup)
            try:
                if self.family == socket.AF_INET:
                    self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_TTL, ttl)
                else:
                    self.sock.setsockopt(socket.IPPROTO_IPV6,
                                         socket.IPV6_UNICAST_HOPS, ttl)
            except OSError:
                pass
        if rx_port:
            self.sock.bind(("" if self.family == socket.AF_INET else "::", rx_port))
        self._dest = ((ip, tx_port) if ip else None)
        self._extra_dests: set = set()
        self.bytes_sent = 0
        self.packets_sent = 0
        self.bytes_received = 0
        self.packets_received = 0
        self._closed = False
        self._recv_thread = None
        self._pending: deque = deque()
        self._recv_queue: Optional["queue.Queue"] = None
        self._rx_lens = None
        self.rtcp = None
        if rtcp:
            from ultragrid_tpu_torch.net.rtcp import RtcpSession

            self.rtcp = RtcpSession(
                self.ssrc,
                addr=addr,
                rx_port=rx_port + 1 if rx_port else 0,
                tx_port=tx_port + 1 if addr else 0,
            )

    def set_receiver(self, addr: str, tx_port: Optional[int] = None) -> None:
        fam, ip = resolve_addr(addr)
        if fam != self.family:
            raise ValueError(
                f"receiver {addr!r} resolves to a different address family "
                "than this session's socket")
        self._dest = (ip, tx_port or self.tx_port)

    def has_receiver(self) -> bool:
        return self._dest is not None or bool(self._extra_dests)

    # extra unicast destinations (RTSP clients; ref: live555 per-client
    # sessions in src/rtsp/BasicRTSPOnlyServer.cpp)
    def add_destination(self, addr: str, port: int) -> None:
        self._extra_dests.add((addr, port))

    def remove_destination(self, addr: str, port: int) -> None:
        self._extra_dests.discard((addr, port))

    def _fanout(self, pkt: bytes) -> None:
        for dest in list(self._extra_dests):
            try:
                self.sock.sendto(pkt, dest)
            except OSError:
                pass

    def send_data_hdr(self, ts: int, pt: int, m: bool, payload_hdr: bytes, data: bytes) -> None:
        """ref: rtp_send_data_hdr (rtp.c); payload = payload_hdr + data,
        sent now from this thread."""
        if self._dest is None and not self._extra_dests:
            return
        seq = self.seq
        self.seq = (self.seq + 1) & 0xFFFF
        hdr = struct.pack("!BBHII", RTP_VERSION << 6, (0x80 if m else 0) | (pt & 0x7F),
                          seq, ts & 0xFFFFFFFF, self.ssrc)
        pkt = hdr + payload_hdr + bytes(data)
        self.bytes_sent += len(pkt)
        self.packets_sent += 1
        if self.rtcp is not None:
            self.rtcp.on_rtp_sent(len(pkt), ts)
        try:
            if self._dest is not None:
                self.sock.sendto(pkt, self._dest)
        except OSError as e:
            log.warning(f"send failed: {e}")
        self._fanout(pkt)

    def send_batch(self, ts: int, pt: int, payload_hdrs, payload: "bytes|object",
                   offsets, sizes, m_last: bool, pace_ns: int = 0) -> int:
        """Batch scatter-gather send through the C hot path
        (csrc/udp_tx.c); the RTP headers are built here, vectorised.

        payload_hdrs: [npkt, hdr_len] uint8 array (payload headers only);
        offsets/sizes: per-packet slices of `payload` (a contiguous buffer).
        """
        npkt = len(sizes)
        if not npkt or not self.has_receiver():
            return 0
        if self._dest is None:
            # RTSP clients only: per-packet sends (the reference's fallback)
            for i in range(npkt):
                self.send_data_hdr(ts, pt, m_last and i == npkt - 1, payload_hdrs[i].tobytes(),
                                   payload[offsets[i]: offsets[i] + sizes[i]])
            return npkt
        lib = udp_tx_lib()
        # prepend RTP headers (vectorized)
        seqs = (self.seq + np.arange(npkt)) & 0xFFFF
        self.seq = int((self.seq + npkt) & 0xFFFF)
        rtp = np.zeros((npkt, 12), np.uint8)
        rtp[:, 0] = RTP_VERSION << 6
        rtp[:, 1] = pt & 0x7F
        if m_last:
            rtp[-1, 1] |= 0x80
        rtp[:, 2] = (seqs >> 8) & 0xFF
        rtp[:, 3] = seqs & 0xFF
        rtp[:, 4:8] = np.frombuffer(struct.pack("!I", ts & 0xFFFFFFFF), np.uint8)
        rtp[:, 8:12] = np.frombuffer(struct.pack("!I", self.ssrc), np.uint8)
        headers = np.ascontiguousarray(
            np.concatenate([rtp, payload_hdrs], axis=1)
        )
        payload_arr = np.ascontiguousarray(
            np.frombuffer(payload, np.uint8)
            if isinstance(payload, (bytes, bytearray, memoryview))
            else payload
        )
        offs = np.ascontiguousarray(np.asarray(offsets, np.int64))
        szs = np.ascontiguousarray(np.asarray(sizes, np.int32))
        # destination sockaddr (dual-stack; _dest holds a numeric ip)
        addr, port = self._dest
        sockaddr = pack_sockaddr(self.family, addr, port)
        n = lib.udp_send_packets(
            self.sock.fileno(), headers.ctypes.data, headers.shape[1],
            payload_arr.ctypes.data, offs.ctypes.data, szs.ctypes.data,
            npkt, pace_ns, sockaddr, len(sockaddr),
        )
        if self._extra_dests:
            # per-client unicast fan-out (RTSP clients); the primary
            # destination rides the C batch sender
            for i in range(npkt):
                self._fanout(headers[i].tobytes() + bytes(payload_arr[offs[i]: offs[i] + szs[i]]))
        if n < 0:
            log.warning("batch send failed (socket error)")
            return 0
        self.packets_sent += int(n)
        self.bytes_sent += int(headers.nbytes + szs.sum())
        if self.rtcp is not None:
            self.rtcp.on_rtp_sent(int(headers.nbytes + szs.sum()), ts)
        return int(n)

    def async_wait(self) -> None:
        """Return once every packet already sent has been handed to the
        kernel (ref: rtp_async_wait, rtp.c:4060-4068).  The port sends from
        the caller's thread, so each send call hands its packets to the
        socket before it returns, and there is no queue to wait for: this
        returns at once.  Kept so that callers of the reference's API run
        unchanged."""

    # -- receive --------------------------------------------------------

    def _parse(self, data: bytes, arrival: float) -> Optional[RtpPacket]:
        if len(data) < RTP_HDR_LEN:
            return None
        b0, b1, seq, ts, ssrc = struct.unpack("!BBHII", data[:RTP_HDR_LEN])
        if b0 >> 6 != RTP_VERSION:
            return None
        cc = b0 & 0xF
        x = (b0 >> 4) & 1
        payload_start = RTP_HDR_LEN + cc * 4
        if x:
            if len(data) < payload_start + 4:
                return None
            (_, xlen) = struct.unpack("!HH", data[payload_start : payload_start + 4])
            payload_start += 4 + xlen * 4
        self.bytes_received += len(data)
        self.packets_received += 1
        if self.rtcp is not None:
            self.rtcp.on_rtp_received(ssrc, seq, ts, arrival)
        return RtpPacket(
            pt=b1 & 0x7F,
            seq=seq,
            ts=ts,
            ssrc=ssrc,
            m=bool(b1 & 0x80),
            payload=data[payload_start:],
            arrival=arrival,
        )

    def recv(self, timeout: float = 0.0001) -> Optional[RtpPacket]:
        """ref: rtp_recv_r with timeout (ultragrid_rtp.c:422)."""
        if self._recv_thread is not None:
            if self._pending:
                return self._pending.popleft()
            try:
                batch = self._recv_queue.get(timeout=timeout)
            except queue.Empty:
                return None
            self._pending.extend(batch)
            return self._pending.popleft()
        self.sock.settimeout(timeout)
        try:
            data, _src = self.sock.recvfrom(RTP_MAX_PACKET_LEN)
        except (socket.timeout, BlockingIOError):
            return None
        except OSError:
            return None
        return self._parse(data, time.monotonic())

    def recv_batch(self, timeout: float = 0.0001, max_pkts: int = 128) -> List[RtpPacket]:
        """Drain up to max_pkts datagrams in ONE recvmmsg syscall (C hot
        path; role analogue of the reference's udp_reader thread +
        net_udp.c:1129-1131 batching)."""
        lib = udp_rx_lib()
        out: List[RtpPacket] = []
        # fresh buffer per batch: payloads below are zero-copy views
        # into it, so it must not be reused while frames reference it
        # (the old design reused one buffer and paid a full-batch
        # .tobytes() copy — ~4 ms per 128-pkt batch at 4K rates)
        buf = np.empty((max_pkts, RTP_MAX_PACKET_LEN), np.uint8)
        if self._rx_lens is None or self._rx_lens.shape[0] < max_pkts:
            self._rx_lens = np.empty(max_pkts, np.int32)
        n = int(lib.udp_recv_batch(
            self.sock.fileno(), buf.ctypes.data, buf.shape[1], max_pkts,
            self._rx_lens.ctypes.data, int(timeout * 1e6),
        ))
        if n <= 0:
            return out
        arrival = time.monotonic()
        # vectorized header parse over the whole batch (per-packet
        # python parsing caps a single core at ~0.4 Gbps)
        lens = self._rx_lens[:n].tolist()
        h = buf[:n, :RTP_HDR_LEN].astype(np.uint32)
        seqs = ((h[:, 2] << 8) | h[:, 3]).tolist()
        tss = ((h[:, 4] << 24) | (h[:, 5] << 16) | (h[:, 6] << 8) | h[:, 7]).tolist()
        ssrcs = ((h[:, 8] << 24) | (h[:, 9] << 16) | (h[:, 10] << 8) | h[:, 11]).tolist()
        b0s = h[:, 0].tolist()
        b1s = h[:, 1].tolist()
        rtcp = self.rtcp
        nbytes = 0
        # payloads are zero-copy memoryview slices into this batch's
        # own buffer (per-packet .tobytes() was ~3 us each at 76k
        # pkts/s; a whole-batch copy was ~4 ms at 4K rates)
        row = buf.shape[1]
        blob = memoryview(buf.reshape(-1))
        for i in range(n):
            ln = lens[i]
            b0 = b0s[i]
            if ln < RTP_HDR_LEN or (b0 >> 6) != RTP_VERSION:
                continue
            if b0 & 0x1F:  # CSRCs or extension present: slow path
                pkt = self._parse(bytes(blob[i * row: i * row + ln]), arrival)
                if pkt is not None:
                    out.append(pkt)
                continue
            nbytes += ln
            b1 = b1s[i]
            if rtcp is not None:
                rtcp.on_rtp_received(ssrcs[i], seqs[i], tss[i], arrival)
            out.append(RtpPacket(
                pt=b1 & 0x7F, seq=seqs[i], ts=tss[i],
                ssrc=ssrcs[i], m=bool(b1 & 0x80),
                payload=blob[i * row + RTP_HDR_LEN: i * row + ln],
                arrival=arrival,
            ))
        self.bytes_received += nbytes
        self.packets_received += len(out)
        return out

    def start_recv_thread(self, queue_size: int = 8192) -> None:
        """Dedicated receive thread feeding an internal queue (ref: the
        reference's udp_reader thread, net_udp.c:163-187): recv() then pops
        from the queue so the decode loop never blocks in the syscall.

        The queue carries whole recvmmsg BATCHES (lists), not single
        packets: per-packet queue.put/get costs ~5-10 us each under GIL
        contention, which alone caps a 1080p uncompressed stream (~540
        pkts/frame) — batching makes the handoff O(batches)."""
        if self._recv_thread is not None:
            return
        self._recv_queue = queue.Queue(maxsize=max(queue_size // 64, 64))
        self._pending: deque = deque()

        def worker():
            while not self._closed:
                try:
                    pkts = self.recv_batch(timeout=0.05)
                except OSError:
                    return
                if pkts:
                    try:
                        self._recv_queue.put_nowait(pkts)
                    except queue.Full:
                        pass  # overrun: drop (the socket buffer smooths bursts)

        self._recv_thread = threading.Thread(target=worker, name="rtp-recv", daemon=True)
        self._recv_thread.start()

    def recv_many(self, timeout: float = 0.0001, max_pkts: int = 512) -> List[RtpPacket]:
        """Drain up to max_pkts received packets in batch granularity (the
        decode loop's preferred entry; one queue op per recvmmsg batch)."""
        if self._recv_thread is None:
            return self.recv_batch(timeout=timeout, max_pkts=max_pkts)
        out: List[RtpPacket] = []
        pending = self._pending
        while pending and len(out) < max_pkts:
            out.append(pending.popleft())
        block = timeout
        while len(out) < max_pkts:
            try:
                batch = self._recv_queue.get(timeout=block)
            except queue.Empty:
                break
            block = 0.0  # only the first get may wait
            room = max_pkts - len(out)
            out.extend(batch[:room])
            pending.extend(batch[room:])
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self.rtcp is not None:
            self.rtcp.close()
        if self._recv_thread is not None:
            self._recv_thread.join(timeout=2)
        self.sock.close()


def get_local_mediatime() -> int:
    """90 kHz RTP media clock (ref: get_local_mediatime, src/tv.h:64)."""
    return int(time.monotonic() * 90000) & 0xFFFFFFFF
