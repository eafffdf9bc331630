"""hd-rum: plain UDP packet reflector, 1 -> N.

The port's copy of ``ultragrid_tpu/tools/hd_rum.py`` (jax-free; copied, not imported, so
the port never runs the JAX package's ``__init__``).

ref: hd-rum-multi/hd-rum.c:157-245 — a bounded ring of received packets
drained by a writer thread that duplicates each datagram to every client.

Run: ``python -m ultragrid_tpu_torch.tools.hd_rum <buffer> <port> <host1> [host2...]``
"""

from __future__ import annotations

import queue
import socket
import sys
import threading
from typing import List, Tuple

from ultragrid_tpu_torch.utils.log import Logger

log = Logger("hd-rum")


class HdRum:
    def __init__(self, port: int, hosts: List[str], buffer_packets: int = 1024,
                 out_port: int = 0, mcast_group: str = ""):
        self.port = port
        self.targets: List[Tuple[str, int]] = [
            (h.rsplit(":", 1)[0], int(h.rsplit(":", 1)[1]) if ":" in h else (out_port or port))
            for h in hosts
        ]
        self.rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 * 1024 * 1024)
        self.rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.rx.bind(("", port))
        if mcast_group:
            # reflector fed by a multicast group: join it on the rx socket
            # (ref: the reference feeds hd-rum from multicast sessions too)
            mreq = socket.inet_aton(mcast_group) + socket.inet_aton("0.0.0.0")
            self.rx.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        self.tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.queue: "queue.Queue" = queue.Queue(maxsize=buffer_packets)
        self._stop = threading.Event()
        self.packets = 0

    def _writer(self) -> None:
        while True:
            pkt = self.queue.get()
            if pkt is None:
                return
            for target in self.targets:
                try:
                    self.tx.sendto(pkt, target)
                except OSError as e:
                    log.warning(f"send to {target} failed: {e}")

    def run(self, packet_limit: int = 0) -> int:
        t = threading.Thread(target=self._writer, daemon=True)
        t.start()
        self.rx.settimeout(0.5)
        while not self._stop.is_set():
            try:
                pkt, _src = self.rx.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            self.packets += 1
            try:
                self.queue.put_nowait(pkt)
            except queue.Full:
                pass  # drop like the reference's bounded ring
            if packet_limit and self.packets >= packet_limit:
                break
        self.queue.put(None)
        t.join(timeout=2)
        return self.packets

    def stop(self) -> None:
        self._stop.set()
        self.rx.close()


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 3:
        print("usage: hd_rum <buffer_packets> <port> [--mcast GROUP] "
              "<host[:port]>...", file=sys.stderr)
        return 1
    mcast = ""
    rest = argv[2:]
    if rest and rest[0] == "--mcast":
        mcast = rest[1]
        rest = rest[2:]
    rum = HdRum(int(argv[1]), rest, buffer_packets=int(argv[0]), mcast_group=mcast)
    log.notice(f"reflecting :{argv[1]} -> {rum.targets}")
    rum.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
