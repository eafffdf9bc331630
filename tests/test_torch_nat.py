"""The port's NAT traversal against the JAX package's, on the CPU.

The cases of ``tests/test_net.py`` for ``net/nat.py`` and
``tools/nat_helper.py`` (hole punching, the nat-helper room, NAT-PMP and PCP
against a scripted gateway, UPnP IGD against a mock gateway, the hole-punched
session set-up), run across the two packages: each client of one package
against the other's server or peer, every request byte-equal to the
reference's (the nonces and transaction ids aside, which both draw from
``os.urandom``), every parsed reply equal.  Everything runs on 127.0.0.1.
"""

import socket
import struct
import threading

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402,F401  (the reference on the CPU)

from ultragrid_tpu.net import nat as ref_nat  # noqa: E402
from ultragrid_tpu.tools import nat_helper as ref_helper  # noqa: E402

from ultragrid_tpu_torch import cli  # noqa: E402
from ultragrid_tpu_torch.net import nat  # noqa: E402
from ultragrid_tpu_torch.tools import nat_helper  # noqa: E402

BOTH = {"port": (nat, nat_helper), "ref": (ref_nat, ref_helper)}


def _udp():
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    return s


@pytest.mark.parametrize("a,b", [("port", "ref"), ("port", "port")])
def test_udp_hole_punch_loopback(a, b):
    sa, sb = _udp(), _udp()
    results = {}

    def run(name, pkg, sock, peer):
        results[name] = BOTH[pkg][0].punch(sock, peer, duration=5.0)

    ta = threading.Thread(target=run, args=("a", a, sa, sb.getsockname()), daemon=True)
    tb = threading.Thread(target=run, args=("b", b, sb, sa.getsockname()), daemon=True)
    ta.start()
    tb.start()
    ta.join(10)
    tb.join(10)
    assert results.get("a") and results.get("b")
    sa.close()
    sb.close()


@pytest.mark.parametrize("server,clients", [("port", ("port", "ref")), ("ref", ("port", "port"))])
def test_nat_helper_room_pairing_and_candidates(server, clients):
    """Two clients (either package) pair through either package's
    coordination server and receive each other's name, description and
    candidates (5-byte length framing)."""
    srv = BOTH[server][1].NatHelperServer(port=0, host="127.0.0.1")
    srv.start()
    try:
        results = {}

        def run(pkg, name, sdp):
            c = BOTH[pkg][0].NatHelperClient("127.0.0.1", srv.port)
            peer, peer_sdp = c.join(name, "testroom", sdp)
            c.send_candidate(f"{name}-cand-1")
            results[name] = (peer, peer_sdp, c.recv_candidate())
            c.close()

        ts = [threading.Thread(target=run, args=(clients[0], "alice", "sdp-a")),
              threading.Thread(target=run, args=(clients[1], "bob", "sdp-b"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=10)
        assert results["alice"] == ("bob", "sdp-b", "bob-cand-1")
        assert results["bob"] == ("alice", "sdp-a", "alice-cand-1")
    finally:
        srv.close()


def test_framing_equals_reference():
    a, b = socket.socketpair()
    try:
        for payload in (b"", b"x", b"room-\xff" * 40):
            nat_helper.send_msg(a, payload)
            assert ref_helper.recv_msg(b) == payload
            ref_helper.send_msg(a, payload)
            assert nat_helper.recv_msg(b) == payload
    finally:
        a.close()
        b.close()


class _Gateway:
    """The scripted NAT-PMP / PCP gateway of ``tests/test_net.py``, keeping
    every request it answered."""

    def __init__(self):
        self.sock = _udp()
        self.port = self.sock.getsockname()[1]
        self.requests = []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while True:
            try:
                data, addr = self.sock.recvfrom(128)
            except OSError:
                return
            self.requests.append(data)
            if data[0] == 0 and data[1] == 1:  # NAT-PMP UDP map
                _, _, _, int_p, ext_p, life = struct.unpack("!BBHHHI", data)
                self.sock.sendto(struct.pack("!BBHIHHI", 0, 0x81, 0, 1, int_p, ext_p or int_p, life), addr)
            elif data[0] == 0 and data[1] == 0:  # public address
                self.sock.sendto(struct.pack("!BBHI", 0, 0x80, 0, 1) + socket.inet_aton("203.0.113.7"), addr)
            elif data[0] == 2 and data[1] == 1:  # PCP MAP
                lifetime = struct.unpack("!I", data[4:8])[0]
                proto, int_p, ext_p = struct.unpack("!B3xHH", data[36:44])
                self.sock.sendto(struct.pack("!BBBBI", 2, 0x81, 0, 0, lifetime) + struct.pack("!I", 1)
                                 + b"\x00" * 12 + data[24:36] + struct.pack("!B3xHH", proto, int_p, ext_p or int_p)
                                 + b"\x00" * 10 + b"\xff\xff" + socket.inet_aton("203.0.113.7"), addr)

    def close(self):
        self.sock.close()


def test_natpmp_and_pcp_against_mock_gateway(monkeypatch):
    """Both packages' NAT-PMP and PCP clients against one scripted gateway:
    equal replies, requests byte-equal but for PCP's random nonce; then the
    traversal order (PCP first) of ``setup_nat_traverse`` in both."""
    gw = _Gateway()
    got = {}
    try:
        for name, mod in (("port", nat), ("ref", ref_nat)):
            monkeypatch.setattr(mod, "NATPMP_PORT", gw.port)
            first = len(gw.requests)
            got[name] = (mod.natpmp_map(5004, 5004, gateway="127.0.0.1"),
                         mod.natpmp_public_address(gateway="127.0.0.1"),
                         mod.pcp_map(5006, 5006, gateway="127.0.0.1", client_ip="127.0.0.1"),
                         mod.setup_nat_traverse(5008, 5010, mode="auto", gateway="127.0.0.1"),
                         gw.requests[first:])
    finally:
        gw.close()
    port, ref = got["port"], got["ref"]
    assert port[0] == ref[0] == (5004, 3600)
    assert port[1] == ref[1] == "203.0.113.7"
    assert port[2] == ref[2] == (5006, "203.0.113.7", 3600)
    assert port[3] == ref[3] == {"mode": "pcp", "mappings": {5008: 5008, 5010: 5010}}
    assert len(port[4]) == len(ref[4])
    for a, b in zip(port[4], ref[4]):
        if a[0] == 2:  # PCP: the 12-byte nonce at 24:36 is random
            a, b = a[:24] + a[36:], b[:24] + b[36:]
        assert a == b


def test_upnp_igd_against_mock_gateway():
    """SSDP discovery and WANIPConnection SOAP (AddPortMapping,
    GetExternalIPAddress, DeletePortMapping) against the mock IGD of
    ``tests/test_net.py``, by both packages: the same replies and the same
    request bodies."""
    import http.server

    bodies = []

    class Igd(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            xml = ('<?xml version="1.0"?><root><device><serviceList><service>'
                   "<serviceType>urn:schemas-upnp-org:service:WANIPConnection:1"
                   "</serviceType><controlURL>/ctl</controlURL>"
                   "</service></serviceList></device></root>").encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(xml)))
            self.end_headers()
            self.wfile.write(xml)

        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0))).decode()
            soap = self.headers.get("SOAPAction", "")
            bodies.append((soap, body))
            if "AddPortMapping" in soap:
                resp = b"<s:Envelope><s:Body><u:AddPortMappingResponse/></s:Body></s:Envelope>"
            elif "GetExternalIPAddress" in soap:
                resp = (b"<s:Envelope><s:Body><u:GetExternalIPAddressResponse>"
                        b"<NewExternalIPAddress>203.0.113.7</NewExternalIPAddress>"
                        b"</u:GetExternalIPAddressResponse></s:Body></s:Envelope>")
            else:
                resp = b"<s:Envelope><s:Body><u:DeletePortMappingResponse/></s:Body></s:Envelope>"
            self.send_response(200)
            self.send_header("Content-Length", str(len(resp)))
            self.end_headers()
            self.wfile.write(resp)

    httpd = http.server.HTTPServer(("127.0.0.1", 0), Igd)
    http_port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    got = {}
    try:
        for name, mod in (("port", nat), ("ref", ref_nat)):
            ssdp = _udp()
            searches = []

            def ssdp_reply(sock=ssdp, seen=searches):
                data, addr = sock.recvfrom(4096)
                seen.append(data.replace(str(sock.getsockname()[1]).encode(), b"PORT"))
                sock.sendto((f"HTTP/1.1 200 OK\r\nLOCATION: http://127.0.0.1:{http_port}/desc.xml"
                             "\r\nST: urn:schemas-upnp-org:device:InternetGatewayDevice:1\r\n\r\n").encode(), addr)

            t = threading.Thread(target=ssdp_reply, daemon=True)
            t.start()
            loc = mod.upnp_discover(ssdp_addr=ssdp.getsockname())
            t.join(5)
            ssdp.close()
            first = len(bodies)
            got[name] = (loc, searches, mod.upnp_map(5004, 5004, desc_url=loc, internal_client="192.0.2.10"),
                         mod.upnp_unmap(5004, desc_url=loc), bodies[first:])
    finally:
        httpd.shutdown()
    port, ref = got["port"], got["ref"]
    assert port[0] == ref[0] == f"http://127.0.0.1:{http_port}/desc.xml"
    assert port[1] == ref[1] and b"M-SEARCH" in port[1][0]
    assert port[2] == ref[2] == (5004, "203.0.113.7", 3600)
    assert port[3] is ref[3] is True
    assert port[4] == ref[4] and "<NewExternalPort>5004</NewExternalPort>" in port[4][0][1]


@pytest.mark.parametrize("a,b", [("port", "ref"), ("port", "port")])
def test_holepunch_establish_pairs_and_punches(a, b):
    """Two endpoints (either package) pair through a nat-helper room,
    exchange host candidates and punch each other's media ports."""
    srv = nat_helper.NatHelperServer(port=0, host="127.0.0.1")
    srv.start()
    socks = [_udp(), _udp()]
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:  # free for holepunch_establish to bind
        s.close()
    try:
        results = {}

        def run(tag, pkg, rx_port):
            mod = BOTH[pkg][0]
            conf = mod.parse_holepunch_conf(f"holepunch:room=punchroom:server=127.0.0.1:{srv.port}:client_name={tag}")
            results[tag] = mod.holepunch_establish(conf, rx_port)

        ts = [threading.Thread(target=run, args=("a", a, ports[0])), threading.Thread(target=run, args=("b", b, ports[1]))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=15)
        assert results["a"][1] == ports[1] and results["b"][1] == ports[0]
    finally:
        srv.close()


def test_holepunch_conf_grammar_equals_reference():
    for conf in ("holepunch:room=r:server=h", "holepunch:room=r:server=h:9999:client_name=n:stun_srv=s:3479",
                 "holepunch:room=r:coord_srv=h:bind_ip=10.0.0.1"):
        assert nat.parse_holepunch_conf(conf) == ref_nat.parse_holepunch_conf(conf)
    for bad in ("holepunch:room=r", "holepunch:server=h"):
        with pytest.raises(ValueError, match="room"):
            nat.parse_holepunch_conf(bad)


def test_cli_nat_traverse_fails_without_a_gateway(monkeypatch, capsys):
    """``-N`` maps the RTP ports before any socket binds; with no gateway
    reachable the CLI stops with the reference's error, as the reference
    does."""
    monkeypatch.setattr(nat, "setup_nat_traverse", lambda rx, audio_rx, mode: {"mode": None, "mappings": {}})
    assert cli.main(["-N", "-t", "testcard", "-P", "6004", "--device", "cpu", "127.0.0.1"]) == 1
    assert "NAT traversal failed" in capsys.readouterr().err
    assert cli.main(["-N", "holepunch:room=r", "-d", "dummy", "--device", "cpu"]) == 1
    assert "holepunch failed" in capsys.readouterr().err
