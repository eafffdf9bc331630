"""NAT traversal helpers: STUN binding discovery + UDP hole punching.

The port's copy of ``ultragrid_tpu/net/nat.py`` (jax-free; copied, not imported, so
the port never runs the JAX package's ``__init__``).

Parity with the reference's traversal stack (ref: src/utils/udp_holepunch.cpp
— libjuice-based punched socket negotiation; src/utils/nat.c — PCP/NAT-PMP/
UPnP port mappings).  This implementation speaks RFC 5389 STUN directly (no
external library): a Binding Request over the media socket discovers the
server-reflexive address, and `punch()` exchanges keepalives so both paths'
NAT state stays open.

PCP/UPnP need a cooperating gateway, which this environment cannot provide;
the STUN + punch path is the one the reference uses for peer-to-peer
sessions via its coordination server.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional, Tuple

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("nat")

STUN_MAGIC_COOKIE = 0x2112A442
STUN_BINDING_REQUEST = 0x0001
STUN_BINDING_RESPONSE = 0x0101
ATTR_MAPPED_ADDRESS = 0x0001
ATTR_XOR_MAPPED_ADDRESS = 0x0020
DEFAULT_STUN_PORT = 3478


def build_binding_request(txid: Optional[bytes] = None) -> bytes:
    """RFC 5389 section 6: 20-byte header, no attributes."""
    txid = txid or os.urandom(12)
    return struct.pack("!HHI", STUN_BINDING_REQUEST, 0, STUN_MAGIC_COOKIE) + txid


def parse_binding_response(data: bytes, txid: bytes) -> Optional[Tuple[str, int]]:
    """Extract the (XOR-)mapped address from a Binding Response."""
    if len(data) < 20:
        return None
    mtype, mlen, cookie = struct.unpack("!HHI", data[:8])
    if mtype != STUN_BINDING_RESPONSE or cookie != STUN_MAGIC_COOKIE:
        return None
    if data[8:20] != txid:
        return None
    pos = 20
    end = min(len(data), 20 + mlen)
    while pos + 4 <= end:
        atype, alen = struct.unpack("!HH", data[pos : pos + 4])
        aval = data[pos + 4 : pos + 4 + alen]
        if atype == ATTR_XOR_MAPPED_ADDRESS and len(aval) >= 8:
            family = aval[1]
            port = struct.unpack("!H", aval[2:4])[0] ^ (STUN_MAGIC_COOKIE >> 16)
            if family == 0x01:
                raw = struct.unpack("!I", aval[4:8])[0] ^ STUN_MAGIC_COOKIE
                ip = socket.inet_ntoa(struct.pack("!I", raw))
                return ip, port
        elif atype == ATTR_MAPPED_ADDRESS and len(aval) >= 8:
            port = struct.unpack("!H", aval[2:4])[0]
            ip = socket.inet_ntoa(aval[4:8])
            return ip, port
        pos += 4 + alen + ((-alen) % 4)
    return None


def stun_discover(
    sock: socket.socket,
    server: str,
    port: int = DEFAULT_STUN_PORT,
    retries: int = 3,
    timeout: float = 1.0,
) -> Optional[Tuple[str, int]]:
    """Learn this socket's server-reflexive (public) address via STUN.

    Uses the MEDIA socket itself so the discovered mapping is the one the
    RTP stream will ride (the same trick the reference's holepunch uses).
    """
    txid = os.urandom(12)
    req = build_binding_request(txid)
    old_timeout = sock.gettimeout()
    try:
        for _ in range(retries):
            sock.sendto(req, (server, port))
            sock.settimeout(timeout)
            try:
                data, _src = sock.recvfrom(2048)
            except socket.timeout:
                continue
            mapped = parse_binding_response(data, txid)
            if mapped:
                log.notice(f"STUN mapped address: {mapped[0]}:{mapped[1]}")
                return mapped
    except OSError as exc:
        log.warning(f"STUN discovery failed: {exc}")
    finally:
        sock.settimeout(old_timeout)
    return None


def punch(
    sock: socket.socket,
    peer: Tuple[str, int],
    duration: float = 1.0,
    interval: float = 0.1,
    token: bytes = b"ug-punch",
) -> bool:
    """Open the NAT path to `peer` by exchanging keepalives.

    Both sides call punch() with each other's reflexive address (learned via
    STUN and swapped over the coordination channel).  Returns True once a
    packet from the peer arrives.
    """
    deadline = time.monotonic() + duration
    old_timeout = sock.gettimeout()
    heard = False
    try:
        while time.monotonic() < deadline:
            try:
                sock.sendto(token, peer)
            except OSError:
                pass
            sock.settimeout(interval)
            try:
                data, src = sock.recvfrom(2048)
                if data == token:
                    heard = True
                    # answer once more so the peer also confirms
                    sock.sendto(token, peer)
                    break
            except socket.timeout:
                continue
    finally:
        sock.settimeout(old_timeout)
    return heard


# ---------------------------------------------------------------------------
# NAT-PMP (RFC 6886) + PCP (RFC 6887) port-mapping clients
# (ref: src/utils/nat.c — UG_NAT_TRAVERSE_PCP / _NAT_PMP via libnatpmp/libpcp;
#  implemented directly on the wire here)
# ---------------------------------------------------------------------------

NATPMP_PORT = 5351
NATPMP_RESULT_OK = 0


def default_gateway() -> Optional[str]:
    """Default-route gateway from /proc/net/route (Linux)."""
    try:
        with open("/proc/net/route") as f:
            for line in f.readlines()[1:]:
                parts = line.split()
                if len(parts) >= 3 and parts[1] == "00000000":
                    return socket.inet_ntoa(struct.pack("<I", int(parts[2], 16)))
    except OSError:
        pass
    return None


def natpmp_map(
    internal_port: int,
    external_port: int = 0,
    lifetime: int = 3600,
    protocol: str = "udp",
    gateway: Optional[str] = None,
    timeout: float = 1.0,
) -> Optional[Tuple[int, int]]:
    """Request a NAT-PMP mapping; returns (external_port, lifetime) or None.

    RFC 6886 §3.3: request [ver=0][op=1(UDP)/2(TCP)][res16][int16][ext16]
    [lifetime32]; response opcode is request|0x80 with a result code.
    """
    gw = gateway or default_gateway()
    if gw is None:
        return None
    op = 1 if protocol == "udp" else 2
    req = struct.pack("!BBHHHI", 0, op, 0, internal_port, external_port, lifetime)
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.sendto(req, (gw, NATPMP_PORT))
        data, _ = sock.recvfrom(64)
    except OSError:
        return None
    finally:
        sock.close()
    if len(data) < 16:
        return None
    ver, rop, result, _epoch, _ip, ext, life = struct.unpack("!BBHIHHI", data[:16])
    if ver != 0 or rop != (op | 0x80) or result != NATPMP_RESULT_OK:
        log.warning(f"NAT-PMP mapping refused (result {result})")
        return None
    return ext, life


def natpmp_public_address(gateway: Optional[str] = None, timeout: float = 1.0) -> Optional[str]:
    """RFC 6886 §3.2 external-address request (opcode 0)."""
    gw = gateway or default_gateway()
    if gw is None:
        return None
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.sendto(struct.pack("!BB", 0, 0), (gw, NATPMP_PORT))
        data, _ = sock.recvfrom(32)
    except OSError:
        return None
    finally:
        sock.close()
    if len(data) < 12:
        return None
    ver, rop, result, _epoch = struct.unpack("!BBHI", data[:8])
    if ver != 0 or rop != 0x80 or result != 0:
        return None
    return socket.inet_ntoa(data[8:12])


PCP_VERSION = 2
PCP_OP_MAP = 1
PCP_PROTO = {"udp": 17, "tcp": 6}


def pcp_map(
    internal_port: int,
    external_port: int = 0,
    lifetime: int = 3600,
    protocol: str = "udp",
    gateway: Optional[str] = None,
    client_ip: Optional[str] = None,
    timeout: float = 1.0,
) -> Optional[Tuple[int, str, int]]:
    """Request a PCP MAP; returns (external_port, external_ip, lifetime).

    RFC 6887 §7.1: 24-byte common header [ver][R|op][res16][lifetime32]
    [client IP as v4-mapped v6, 16 B] + 36-byte MAP payload [nonce 12]
    [proto][res 3][int16][ext16][suggested external IP 16 B].
    """
    gw = gateway or default_gateway()
    if gw is None:
        return None
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.connect((gw, NATPMP_PORT))
        my_ip = client_ip or sock.getsockname()[0]
        v4mapped = b"\x00" * 10 + b"\xff\xff" + socket.inet_aton(my_ip)
        nonce = os.urandom(12)
        req = (
            struct.pack("!BBHI", PCP_VERSION, PCP_OP_MAP, 0, lifetime)
            + v4mapped
            + nonce
            + struct.pack("!B3xHH", PCP_PROTO[protocol], internal_port, external_port)
            + b"\x00" * 10 + b"\xff\xff" + socket.inet_aton("0.0.0.0")
        )
        sock.send(req)
        data = sock.recv(128)
    except OSError:
        return None
    finally:
        sock.close()
    if len(data) < 60:
        return None
    ver, rop, _res, result = struct.unpack("!BBBB", data[:4])
    (life,) = struct.unpack("!I", data[4:8])
    if ver != PCP_VERSION or rop != (PCP_OP_MAP | 0x80) or result != 0:
        log.warning(f"PCP MAP refused (result {result})")
        return None
    if data[24:36] != nonce:
        return None
    _proto, int_p, ext_p = struct.unpack("!B3xHH", data[36:44])
    ext_ip = socket.inet_ntoa(data[56:60])  # low 4 bytes of v4-mapped address
    if int_p != internal_port:
        return None
    return ext_p, ext_ip, life


def setup_nat_traverse(
    video_rx_port: int,
    audio_rx_port: int = 0,
    mode: str = "auto",
    gateway: Optional[str] = None,
) -> dict:
    """Try PCP, then NAT-PMP (ref: nat.c traversal order: PCP first,
    NAT-PMP next, UPnP last).  Returns a dict of achieved mappings."""
    out: dict = {"mode": None, "mappings": {}}
    ports = [p for p in (video_rx_port, audio_rx_port) if p]
    if mode in ("auto", "pcp"):
        ok = True
        for p in ports:
            r = pcp_map(p, p, gateway=gateway)
            if r is None:
                ok = False
                break
            out["mappings"][p] = r[0]
        if ok and ports:
            out["mode"] = "pcp"
            return out
    if mode in ("auto", "natpmp", "nat-pmp"):
        ok = True
        out["mappings"].clear()
        for p in ports:
            r = natpmp_map(p, p, gateway=gateway)
            if r is None:
                ok = False
                break
            out["mappings"][p] = r[0]
        if ok and ports:
            out["mode"] = "natpmp"
            return out
    if mode in ("auto", "upnp"):
        ok = True
        out["mappings"].clear()
        for p in ports:
            r = upnp_map(p, p)
            if r is None:
                ok = False
                break
            out["mappings"][p] = r[0]
        if ok and ports:
            out["mode"] = "upnp"
            return out
    out["mappings"].clear()
    return out


# ---------------------------------------------------------------------------
# nat-helper coordination client (ref: nat-helper/ + src/utils/udp_holepunch.cpp
# — the reference's hole-punch client pairs through the same room protocol)
# ---------------------------------------------------------------------------


class NatHelperClient:
    """Pairs two endpoints through a nat-helper room and exchanges
    SDP-style descriptions + candidates."""

    def __init__(self, host: str, port: int = 12558, timeout: float = 10.0):
        from ultragrid_tpu_torch.tools.nat_helper import recv_msg, send_msg

        self._send_msg = send_msg
        self._recv_msg = recv_msg
        self.sock = socket.create_connection((host, port), timeout=timeout)

    def join(self, name: str, room: str, sdp: str) -> Tuple[str, str]:
        """Send name/room/description; block until the peer's name and
        description arrive (README steps 1-5)."""
        self._send_msg(self.sock, name.encode())
        self._send_msg(self.sock, room.encode())
        self._send_msg(self.sock, sdp.encode())
        peer_name = self._recv_msg(self.sock)
        peer_sdp = self._recv_msg(self.sock)
        if peer_name is None or peer_sdp is None:
            raise ConnectionError("nat-helper closed during pairing")
        return peer_name.decode(), peer_sdp.decode()

    def send_candidate(self, cand: str) -> None:
        self._send_msg(self.sock, cand.encode())

    def recv_candidate(self) -> Optional[str]:
        msg = self._recv_msg(self.sock)
        return msg.decode() if msg is not None else None

    def close(self) -> None:
        self.sock.close()


# ---------------------------------------------------------------------------
# UPnP IGD (SSDP discovery + WANIPConnection SOAP) — the third traversal
# option alongside PCP/NAT-PMP.  The reference links libnatpmp/libpcp for
# those two; UPnP rounds out the common home-gateway trio.
# ---------------------------------------------------------------------------

SSDP_ADDR = ("239.255.255.250", 1900)
_IGD_ST = "urn:schemas-upnp-org:device:InternetGatewayDevice:1"
_WANIP = "urn:schemas-upnp-org:service:WANIPConnection:1"


def upnp_discover(timeout: float = 2.0, ssdp_addr=None) -> Optional[str]:
    """SSDP M-SEARCH for an IGD; returns the device-description URL."""
    addr = ssdp_addr or SSDP_ADDR
    msg = (
        "M-SEARCH * HTTP/1.1\r\n"
        f"HOST: {addr[0]}:{addr[1]}\r\n"
        'MAN: "ssdp:discover"\r\n'
        "MX: 2\r\n"
        f"ST: {_IGD_ST}\r\n\r\n"
    ).encode()
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.settimeout(timeout)
    try:
        sock.sendto(msg, addr)
        deadline = time.time() + timeout
        while time.time() < deadline:
            try:
                data, _ = sock.recvfrom(4096)
            except socket.timeout:
                return None
            for line in data.decode(errors="replace").split("\r\n"):
                k, _, v = line.partition(":")
                if k.strip().lower() == "location":
                    return v.strip()
        return None
    except OSError:
        return None
    finally:
        sock.close()


def _upnp_control_url(desc_url: str, timeout: float = 3.0) -> Optional[str]:
    """Fetch the IGD description XML and find WANIPConnection's controlURL."""
    import re as _re
    import urllib.request
    from urllib.parse import urljoin

    try:
        with urllib.request.urlopen(desc_url, timeout=timeout) as resp:
            xml = resp.read().decode(errors="replace")
    except Exception:
        return None
    # find the service block for WANIPConnection
    for m in _re.finditer(r"<service>(.*?)</service>", xml, _re.S):
        block = m.group(1)
        if _WANIP in block:
            cm = _re.search(r"<controlURL>(.*?)</controlURL>", block, _re.S)
            if cm:
                return urljoin(desc_url, cm.group(1).strip())
    return None


def _upnp_soap(control_url: str, action: str, args: dict, timeout: float = 3.0) -> Optional[str]:
    import urllib.request

    body_args = "".join(f"<{k}>{v}</{k}>" for k, v in args.items())
    body = (
        '<?xml version="1.0"?>'
        '<s:Envelope xmlns:s="http://schemas.xmlsoap.org/soap/envelope/" '
        's:encodingStyle="http://schemas.xmlsoap.org/soap/encoding/">'
        f'<s:Body><u:{action} xmlns:u="{_WANIP}">{body_args}</u:{action}>'
        "</s:Body></s:Envelope>"
    ).encode()
    req = urllib.request.Request(
        control_url,
        data=body,
        headers={
            "Content-Type": 'text/xml; charset="utf-8"',
            "SOAPAction": f'"{_WANIP}#{action}"',
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read().decode(errors="replace")
    except Exception:
        return None


def upnp_map(
    internal_port: int,
    external_port: int = 0,
    lifetime: int = 3600,
    protocol: str = "udp",
    desc_url: Optional[str] = None,
    ssdp_addr=None,
    internal_client: Optional[str] = None,
) -> Optional[Tuple[int, str, int]]:
    """AddPortMapping on a UPnP IGD; returns (external_port, external_ip,
    lifetime) like natpmp_map/pcp_map, or None."""
    url = desc_url or upnp_discover(ssdp_addr=ssdp_addr)
    if url is None:
        return None
    control = _upnp_control_url(url)
    if control is None:
        return None
    ext = external_port or internal_port
    if internal_client is None:
        probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            probe.connect(("8.8.8.8", 53))
            internal_client = probe.getsockname()[0]
        except OSError:
            internal_client = "127.0.0.1"
        finally:
            probe.close()
    resp = _upnp_soap(control, "AddPortMapping", {
        "NewRemoteHost": "",
        "NewExternalPort": ext,
        "NewProtocol": protocol.upper(),
        "NewInternalPort": internal_port,
        "NewInternalClient": internal_client,
        "NewEnabled": 1,
        "NewPortMappingDescription": "UltraGrid-TPU",
        "NewLeaseDuration": lifetime,
    })
    if resp is None or "AddPortMappingResponse" not in resp:
        return None
    ext_ip = ""
    ip_resp = _upnp_soap(control, "GetExternalIPAddress", {})
    if ip_resp:
        import re as _re

        m = _re.search(r"<NewExternalIPAddress>(.*?)</NewExternalIPAddress>", ip_resp)
        if m:
            ext_ip = m.group(1)
    return ext, ext_ip, lifetime


def upnp_unmap(external_port: int, protocol: str = "udp",
               desc_url: Optional[str] = None, ssdp_addr=None) -> bool:
    url = desc_url or upnp_discover(ssdp_addr=ssdp_addr)
    if url is None:
        return False
    control = _upnp_control_url(url)
    if control is None:
        return False
    resp = _upnp_soap(control, "DeletePortMapping", {
        "NewRemoteHost": "",
        "NewExternalPort": external_port,
        "NewProtocol": protocol.upper(),
    })
    return resp is not None and "DeletePortMappingResponse" in resp


# ---------------------------------------------------------------------------
# Hole-punched session establishment (ref: src/utils/udp_holepunch.cpp —
# join a nat-helper room, exchange reflexive candidates, punch, then run the
# normal RTP session through the opened mapping.  -N holepunch:room=...)
# ---------------------------------------------------------------------------


def parse_holepunch_conf(conf: str) -> dict:
    """``holepunch:room=<room>:server=<host>[:port][:client_name=<n>]
    [:stun_srv=<host[:port]>][:bind_ip=<addr>]``
    (ref grammar: main.cpp:439-448 parse_holepunch_conf)."""
    out = {"room": None, "server": None, "port": 12558,
           "client_name": None, "stun": None, "bind_ip": ""}
    toks = [t for t in conf.split(":") if t]
    i = 1 if toks and toks[0] == "holepunch" else 0
    while i < len(toks):
        key, _, val = toks[i].partition("=")
        if key == "room":
            out["room"] = val
        elif key in ("server", "coord_srv"):
            out["server"] = val
            if i + 1 < len(toks) and toks[i + 1].isdigit():
                out["port"] = int(toks[i + 1])
                i += 1
        elif key == "client_name":
            out["client_name"] = val
        elif key == "stun_srv":
            host = val
            port = DEFAULT_STUN_PORT
            if i + 1 < len(toks) and toks[i + 1].isdigit():
                port = int(toks[i + 1])
                i += 1
            out["stun"] = (host, port)
        elif key == "bind_ip":
            out["bind_ip"] = val
        i += 1
    if not out["room"] or not out["server"]:
        raise ValueError(
            "holepunch needs room=<room> and server=<host> "
            "(-N holepunch:room=R:server=H[:port][:client_name=N]"
            "[:stun_srv=H[:P]][:bind_ip=A])")
    return out


def holepunch_establish(conf: dict, rx_port: int) -> Tuple[str, int]:
    """Open a NAT path for one medium; returns the peer's (host, port).

    The media socket itself is used for STUN + punching so the created NAT
    mapping is the one RTP will ride; it is closed right before the RTP
    session rebinds the same local port (the mapping persists — NATs key on
    the 5-tuple/source port, and RTP traffic resumes the keepalive role).
    """
    import platform

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((conf.get("bind_ip") or "", rx_port))
    local_port = sock.getsockname()[1]

    mapped = None
    if conf.get("stun"):
        mapped = stun_discover(sock, conf["stun"][0], conf["stun"][1])
    if mapped is None:
        # LAN / no STUN: advertise the local address (the reference's ICE
        # host candidates cover this case)
        host_ip = socket.gethostbyname(socket.gethostname())
        mapped = (host_ip, local_port)
        log.notice(f"holepunch: using host candidate {host_ip}:{local_port}")

    client = NatHelperClient(conf["server"], conf["port"])
    try:
        name = conf.get("client_name") or platform.node() or "ug-tpu"
        desc = f"{mapped[0]}:{mapped[1]}"
        peer_name, peer_desc = client.join(name, conf["room"], desc)
        log.notice(f"holepunch: paired with {peer_name!r} at {peer_desc}")
        ip, _, port_s = peer_desc.rpartition(":")
        peer = (ip, int(port_s))
        punch(sock, peer)
    finally:
        client.close()
        sock.close()
    return peer
