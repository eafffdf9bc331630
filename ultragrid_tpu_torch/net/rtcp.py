"""The port's copy of ``ultragrid_tpu/net/rtcp.py`` (jax-free).

Minimal RTCP: SR / RR / SDES on the odd port (ref: src/rtp/rtp.c RTCP
handling — SR/RR/SDES/BYE with member database and loss/jitter stats).

Receiver statistics (highest seq, loss, interarrival jitter) follow RFC 3550
Appendix A; the reference uses the same bookkeeping (rtp.c:160-291).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Dict, Optional

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("rtcp")

RTCP_SR = 200
RTCP_RR = 201
RTCP_SDES = 202
RTCP_BYE = 203

NTP_EPOCH_OFFSET = 2208988800  # 1900 -> 1970


class SourceStats:
    """Per-SSRC reception statistics (RFC 3550 A.1/A.3/A.8)."""

    def __init__(self, seq: int):
        self.base_seq = seq
        self.max_seq = seq
        self.cycles = 0
        self.received = 0
        self.expected_prior = 0
        self.received_prior = 0
        self.jitter = 0.0
        self.transit: Optional[float] = None

    def update(self, seq: int, rtp_ts: int, arrival: float) -> None:
        self.received += 1
        if seq < 0x1000 and self.max_seq > 0xF000:
            self.cycles += 1 << 16
            self.max_seq = seq
        elif seq > self.max_seq:
            self.max_seq = seq
        transit = arrival * 90000 - rtp_ts
        if self.transit is not None:
            d = abs(transit - self.transit)
            self.jitter += (d - self.jitter) / 16.0
        self.transit = transit

    @property
    def extended_max(self) -> int:
        return self.cycles + self.max_seq

    def report_block(self, ssrc: int) -> bytes:
        expected = self.extended_max - self.base_seq + 1
        lost = max(0, expected - self.received)
        exp_int = expected - self.expected_prior
        rec_int = self.received - self.received_prior
        self.expected_prior = expected
        self.received_prior = self.received
        lost_int = exp_int - rec_int
        fraction = 0 if exp_int == 0 else max(0, min(255, (lost_int << 8) // exp_int))
        return struct.pack(
            "!IBBHIIII",
            ssrc,
            fraction,
            (lost >> 16) & 0xFF,
            lost & 0xFFFF,
            self.extended_max & 0xFFFFFFFF,
            int(self.jitter) & 0xFFFFFFFF,
            0,  # LSR
            0,  # DLSR
        )


def _ntp_now() -> tuple:
    t = time.time() + NTP_EPOCH_OFFSET
    sec = int(t)
    frac = int((t - sec) * (1 << 32))
    return sec & 0xFFFFFFFF, frac & 0xFFFFFFFF


class RtcpSession:
    """RTCP endpoint on rtp_port + 1 (reports every `interval` seconds)."""

    def __init__(
        self,
        ssrc: int,
        addr: Optional[str] = None,
        rx_port: int = 0,
        tx_port: int = 0,
        cname: str = "ultragrid-tpu",
        interval: float = 5.0,
    ):
        self.ssrc = ssrc
        self.cname = cname.encode()[:255]
        self.interval = interval
        from ultragrid_tpu_torch.net.rtp import is_multicast, resolve_addr

        family, ip = resolve_addr(addr)
        self.sock = socket.socket(family, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if is_multicast(family, ip):
            try:
                self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            except (OSError, AttributeError):
                pass
            if family == socket.AF_INET:
                mreq = socket.inet_aton(ip) + socket.inet_aton("0.0.0.0")
                self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
                self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
            else:
                import struct as _struct

                mreq = socket.inet_pton(socket.AF_INET6, ip) + _struct.pack("@I", 0)
                self.sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_JOIN_GROUP, mreq)
                self.sock.setsockopt(socket.IPPROTO_IPV6, socket.IPV6_MULTICAST_LOOP, 1)
        if rx_port:
            self.sock.bind(("" if family == socket.AF_INET else "::", rx_port))
        self._dest = (ip, tx_port) if ip else None
        self.sources: Dict[int, SourceStats] = {}
        # sender stats provided by the RTP session
        self.packets_sent = 0
        self.octets_sent = 0
        self.last_rtp_ts = 0
        self.remote_reports: Dict[int, dict] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="rtcp", daemon=True)
        self._thread.start()

    # -- stats feed ------------------------------------------------------

    def on_rtp_received(self, ssrc: int, seq: int, rtp_ts: int, arrival: float) -> None:
        src = self.sources.get(ssrc)
        if src is None:
            src = self.sources[ssrc] = SourceStats(seq)
        src.update(seq, rtp_ts, arrival)

    def on_rtp_sent(self, nbytes: int, rtp_ts: int) -> None:
        self.packets_sent += 1
        self.octets_sent += nbytes
        self.last_rtp_ts = rtp_ts

    # -- packet building -------------------------------------------------

    # set by the fast receive path to merge C-side reception stats into
    # self.sources just before a report is built (net/vrx_fast.py)
    pre_report_hook = None

    def _build_compound(self) -> bytes:
        if self.pre_report_hook is not None:
            try:
                self.pre_report_hook(self)
            except Exception:  # noqa: BLE001 — stats merge must not kill RTCP
                pass
        blocks = b"".join(
            st.report_block(ssrc) for ssrc, st in list(self.sources.items())
        )
        nblocks = len(self.sources)
        if self.packets_sent:
            ntp_s, ntp_f = _ntp_now()
            body = struct.pack(
                "!IIIIII",
                self.ssrc, ntp_s, ntp_f, self.last_rtp_ts,
                self.packets_sent, self.octets_sent,
            ) + blocks
            hdr = struct.pack(
                "!BBH", 0x80 | (nblocks & 0x1F), RTCP_SR, (len(body) + 4) // 4
            )
            report = hdr + body
        else:
            body = struct.pack("!I", self.ssrc) + blocks
            hdr = struct.pack(
                "!BBH", 0x80 | (nblocks & 0x1F), RTCP_RR, (len(body) + 4) // 4
            )
            report = hdr + body
        # SDES CNAME
        item = struct.pack("!IBB", self.ssrc, 1, len(self.cname)) + self.cname
        pad = (-len(item)) % 4
        item += bytes(pad)
        sdes = struct.pack("!BBH", 0x81, RTCP_SDES, (len(item) + 4) // 4 - 1) + item
        return report + sdes

    def _parse(self, data: bytes) -> None:
        pos = 0
        while pos + 4 <= len(data):
            b0, pt, length = struct.unpack("!BBH", data[pos : pos + 4])
            size = (length + 1) * 4
            if pt == RTCP_SR and pos + 28 <= len(data):
                ssrc, ntp_s, ntp_f, rtp_ts, pkts, octets = struct.unpack(
                    "!IIIIII", data[pos + 4 : pos + 28]
                )
                self.remote_reports[ssrc] = {
                    "type": "SR", "packets": pkts, "octets": octets,
                    "time": time.time(),
                }
            elif pt == RTCP_RR and pos + 8 <= len(data):
                (ssrc,) = struct.unpack("!I", data[pos + 4 : pos + 8])
                rc = b0 & 0x1F
                off = pos + 8
                for _ in range(rc):
                    if off + 24 > len(data):
                        break
                    rb = struct.unpack("!IBBHIIII", data[off : off + 24])
                    self.remote_reports[ssrc] = {
                        "type": "RR", "fraction_lost": rb[1] / 256.0,
                        # cumulative lost is a 24-bit field: high byte + low 16
                        "lost": (rb[2] << 16) | rb[3],
                        "ext_seq": rb[4],
                        "jitter": rb[5], "time": time.time(),
                    }
                    off += 24
            pos += size

    # -- loop -------------------------------------------------------------

    def _loop(self) -> None:
        try:
            self.sock.settimeout(0.1)
        except OSError:
            return  # session closed before the loop started

        last_report = time.monotonic()
        while not self._stop.is_set():
            try:
                data, src = self.sock.recvfrom(4096)
                self._parse(data)
                if self._dest is None:
                    # receive-only session: learn the peer from its SRs so
                    # RRs flow back (symmetric RTCP; the reference's member
                    # database serves this role, rtp.c source tracking)
                    self._dest = src
            except socket.timeout:
                pass
            except OSError:
                return
            # interval is re-read each pass so runtime changes take effect
            if time.monotonic() - last_report >= self.interval:
                if self._dest is not None:
                    try:
                        self.sock.sendto(self._build_compound(), self._dest)
                    except OSError:
                        pass
                last_report = time.monotonic()
    def close(self) -> None:
        if self._dest is not None:
            # BYE
            try:
                bye = struct.pack("!BBHI", 0x81, RTCP_BYE, 1, self.ssrc)
                self.sock.sendto(bye, self._dest)
            except OSError:
                pass
        self._stop.set()
        self.sock.close()
