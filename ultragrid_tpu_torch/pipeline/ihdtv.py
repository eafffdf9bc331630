"""iHDTV rxtx protocol (legacy interop).

Parity with the reference's ihdtv transport (ref: src/rxtx/ihdtv.cpp +
src/ihdtv/ihdtv.{h,c}): a fixed 1920x1080 v210 frame (5,529,600 B,
ihdtv.c:140,164) is split into top/bottom halves carried on TWO UDP streams
(ports 3000/3001, rxtx/ihdtv.cpp:174), each packet being a packed 16-byte
host-endian header [stream_id u32][offset u32][frame_number u64]
(ihdtv.h ihdtv_packet) followed by up to ``mtu`` data bytes.  The receiver
assembles by (stream, offset) until the packet count reaches
packets-per-frame, flushing early when a newer frame's packet arrives (the
reference's pending-packet mechanism, ihdtv.c:388-470).

The port of ``ultragrid_tpu/pipeline/ihdtv.py``.  The sender converts each
captured frame to v210 with the port's ``pixfmt.convert_frame`` on the
capture's device (the card unless ``device="cpu"``) and copies it to the
host once for the sockets; the receiver assembles on the host and uploads
each frame once to the display's device.  The packets and the assembly are
the reference's, byte for byte.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ultragrid_tpu_torch.device import get_device, pipeline_stream, stream_context
from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
from ultragrid_tpu_torch.modules.video_display import initialize_video_display
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("ihdtv")

IHDTV_W, IHDTV_H = 1920, 1080
BYTES_PER_FRAME = 5_529_600  # 1920x1080 v210 (ihdtv.c:140)
HALF = BYTES_PER_FRAME // 2
HDR = struct.Struct("<IIQ")  # stream_id, offset, frame_number (packed LE)
MAX_DATA = 65520  # ihdtv_packet.data[]
DEFAULT_PORTS = (3000, 3001)


def _packets_per_half(mtu: int) -> Tuple[int, int]:
    """(packets, last_packet_size) per half frame (ihdtv.c:142-156)."""
    data = min(mtu, MAX_DATA)
    n, rem = divmod(HALF, data)
    if rem:
        return n + 1, rem
    return n, data


class IhdtvConnection:
    """One endpoint; tx and/or rx halves."""

    def __init__(self, mtu: int = 8192, ports: Tuple[int, int] = DEFAULT_PORTS):
        self.data_per_packet = min(mtu, MAX_DATA)
        self.packets_per_half, self.last_size = _packets_per_half(mtu)
        self.packets_per_frame = 2 * self.packets_per_half
        self.ports = ports
        self.current_frame = 0
        self._pending: Optional[bytes] = None
        self.rx_socks = None
        self.tx_socks = None
        self.targets = None

    def init_rx(self) -> None:
        self.rx_socks = []
        for p in self.ports:
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
            s.bind(("", p))
            s.setblocking(False)
            self.rx_socks.append(s)

    def init_tx(self, addr1: str, addr2: Optional[str] = None) -> None:
        self.tx_socks = [
            socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(2)
        ]
        self.targets = [(addr1, self.ports[0]), (addr2 or addr1, self.ports[1])]

    def send(self, data: bytes) -> None:
        """Send one frame buffer as two half-frame streams (ihdtv_send)."""
        assert len(data) >= BYTES_PER_FRAME
        fn = self.current_frame
        rel = 0
        for i in range(self.packets_per_half):
            size = self.data_per_packet if i < self.packets_per_half - 1 else self.last_size
            for sid in (0, 1):
                chunk = data[sid * HALF + rel : sid * HALF + rel + size]
                self.tx_socks[sid].sendto(
                    HDR.pack(sid, rel, fn) + chunk, self.targets[sid]
                )
            rel += size
        self.current_frame += 1

    def receive(self, timeout: float = 5.0) -> Optional[bytearray]:
        """Assemble one frame; early-flush on a newer frame's packet."""
        buf = bytearray(BYTES_PER_FRAME)
        count = 0
        if self._pending is not None:
            count += self._apply(buf, self._pending)
            self._pending = None
        deadline = time.time() + timeout
        while time.time() < deadline:
            progressed = False
            for s in self.rx_socks:
                try:
                    pkt = s.recv(HDR.size + MAX_DATA)
                except BlockingIOError:
                    continue
                except OSError:
                    return None
                progressed = True
                if len(pkt) <= HDR.size:
                    continue
                sid, _, fn = HDR.unpack_from(pkt)
                if sid not in (0, 1):
                    continue
                if fn > self.current_frame or fn + 10 < self.current_frame:
                    # unexpected frame: flush, keep this packet pending
                    self.current_frame = fn
                    self._pending = pkt
                    return buf
                if fn == self.current_frame:
                    count += self._apply(buf, pkt)
                    if count == self.packets_per_frame:
                        self.current_frame += 1
                        return buf
            if not progressed:
                time.sleep(0.0005)
        return None

    def _apply(self, buf: bytearray, pkt: bytes) -> int:
        sid, off, _ = HDR.unpack_from(pkt)
        data = pkt[HDR.size:]
        base = sid * HALF + off
        if base + len(data) > BYTES_PER_FRAME:
            return 0
        buf[base : base + len(data)] = data
        return 1

    def close(self) -> None:
        for group in (self.rx_socks, self.tx_socks):
            for s in group or []:
                try:
                    s.close()
                except OSError:
                    pass


IHDTV_DESC = VideoDesc(IHDTV_W, IHDTV_H, Codec.v210, 30.0)


def run_ihdtv_sender(capture_spec: str, addr: str, mtu: int = 8192,
                     frame_limit: Optional[int] = None,
                     ports: Tuple[int, int] = DEFAULT_PORTS, device="cuda") -> int:
    """Capture -> (convert to v210 1080p on the capture's device) -> ihdtv
    UDP pair."""
    dev = get_device(device)
    cap = initialize_video_capture(capture_spec, device=dev)
    conn = IhdtvConnection(mtu=mtu, ports=ports)
    conn.init_tx(addr)
    sent = 0
    try:
        with stream_context(pipeline_stream(dev)):
            while frame_limit is None or sent < frame_limit:
                frame, _ = cap.grab()
                if frame is None:
                    continue
                d = frame.desc
                if (d.width, d.height) != (IHDTV_W, IHDTV_H):
                    log.error("ihdtv requires 1920x1080 capture")
                    return 1
                data = frame.data
                if d.color_spec != Codec.v210:
                    data = pixfmt.convert_frame(data, d.width, d.color_spec, Codec.v210, device=dev)
                raw = data.cpu().numpy() if isinstance(data, torch.Tensor) else np.asarray(data, np.uint8)
                conn.send(raw.tobytes()[:BYTES_PER_FRAME])
                sent += 1
    finally:
        cap.done()
        conn.close()
    log.notice(f"{sent} frames sent (ihdtv)")
    return 0


def run_ihdtv_receiver(display_spec: str, frame_limit: Optional[int] = None,
                       mtu: int = 8192,
                       ports: Tuple[int, int] = DEFAULT_PORTS, device="cuda") -> int:
    """ihdtv UDP pair -> v210 frames on ``device`` -> display."""
    dev = get_device(device)
    disp = initialize_video_display(display_spec, device=dev)
    disp.reconfigure(IHDTV_DESC)
    # bring the card up (CUDA's start-up takes about a second) before the
    # sockets are bound: at the first frame, the sender's datagrams would
    # overflow the socket buffers meanwhile (no FEC: a frame that loses one
    # is lost)
    torch.zeros(BYTES_PER_FRAME, dtype=torch.uint8).to(dev)
    conn = IhdtvConnection(mtu=mtu, ports=ports)
    conn.init_rx()
    shown = 0
    try:
        with stream_context(pipeline_stream(dev)):
            while frame_limit is None or shown < frame_limit:
                buf = conn.receive()
                if buf is None:
                    break
                arr = torch.frombuffer(buf, dtype=torch.uint8).reshape(IHDTV_H, -1).to(dev)  # one upload
                disp.put_frame(VideoFrame(IHDTV_DESC, [arr], timestamp=time.time()))
                shown += 1
    finally:
        disp.put_frame(None)
        disp.done()
        conn.close()
    log.notice(f"{shown} frames shown (ihdtv)")
    return 0
