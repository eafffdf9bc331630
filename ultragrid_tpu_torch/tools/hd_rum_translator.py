"""hd-rum-transcode: transcoding reflector.

ref: src/hd-rum-translator/hd-rum-translator.cpp:6-12 — a reflector that
shares one decompressor for the incoming stream and recompresses
independently for each client (different codec/quality per output).

Run: ``python -m ultragrid_tpu_torch.tools.hd_rum_translator <rx_port> \
        [-c compress] host[:port] ... [--device cpu]``
Plain clients (no -c prefix) get raw packet reflection semantics via
re-send of the decoded stream with the same codec.

The port of ``ultragrid_tpu/tools/hd_rum_translator.py``: the shared
decompressor and each client's compressor run on the translator's device
(the card unless ``--device`` names another; a ``-c jpeg`` client runs kernel
K1 there), every thread in the translator's one CUDA stream.
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import List, Optional, Tuple

from ultragrid_tpu_torch.device import get_device, pipeline_stream, stream_context
from ultragrid_tpu_torch.modules.video_compress import compress_init
from ultragrid_tpu_torch.modules.video_decompress import decompress_init
from ultragrid_tpu_torch.net.pbuf import PlayoutBuffer
from ultragrid_tpu_torch.net.rtp import RtpSession
from ultragrid_tpu_torch.net.transmit import Tx
from ultragrid_tpu_torch.net.video_rx import VideoRxState
from ultragrid_tpu_torch.tools._bench import device_arg
from ultragrid_tpu_torch.types import Codec, is_codec_opaque
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("hd-rum-transcode")


class TranslatorClient:
    """One output leg with its OWN recompress thread + bounded queue, so a
    slow client drops its own frames instead of stalling the reflector
    loop and every other client (ref: a recompress worker per output,
    src/hd-rum-translator/hd-rum-recompress.cpp)."""

    def __init__(self, host: str, port: int, compress_spec: str, mtu: int = 1500, device="cuda", stream=None):
        self.session = RtpSession(addr=host, rx_port=0, tx_port=port, mtu=mtu)
        self.compress = compress_init(compress_spec, device) if compress_spec != "none" else None
        self.compress_spec = compress_spec
        self.tx = Tx(mtu=mtu, device=device)
        self.stream = stream
        self.dropped = 0
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._thread = threading.Thread(
            target=self._worker, name=f"recompress-{host}:{port}", daemon=True
        )
        self._thread.start()

    def forward(self, frame) -> None:
        try:
            self._q.put_nowait(frame)
        except queue.Full:
            self.dropped += 1  # this client is too slow; others unaffected

    def _worker(self) -> None:
        with stream_context(self.stream):
            self._loop()

    def _loop(self) -> None:
        while True:
            frame = self._q.get()
            if frame is None:
                return
            try:
                out = frame
                if self.compress is not None:
                    out = self.compress.compress(frame)
                    if out is None:
                        continue
                self.tx.send_video(self.session, out)
            except Exception as e:  # noqa: BLE001 - a bad frame must not
                # kill this client's leg
                log.warning(f"client {self.compress_spec} forward failed: {e}")

    def close(self) -> None:
        self._q.put(None)
        # generous drain: the first frame may still be compiling its codec
        # graph; closing the session under a mid-send worker loses frames
        self._thread.join(timeout=30)
        self.session.close()


class HdRumTranslator:
    def __init__(self, rx_port: int, clients: List[Tuple[str, int, str]], device="cuda"):
        self.device = get_device(device)
        self.stream = pipeline_stream(self.device)
        self.session = RtpSession(addr=None, rx_port=rx_port, tx_port=0)
        self.pbuf = PlayoutBuffer()
        self.rx_state = VideoRxState(device=self.device)
        self.clients = [TranslatorClient(h, p, c, device=self.device, stream=self.stream) for h, p, c in clients]
        self._decompress = None
        self._comp_codec = None
        self.frames_forwarded = 0

    def _handle(self, node) -> bool:
        frame = self.rx_state.decode_frame(node)
        if frame is None:
            return False
        needs_decomp = any(c.compress is not None for c in self.clients)
        if needs_decomp and is_codec_opaque(frame.desc.color_spec):
            if self._decompress is None or self._comp_codec != frame.desc.color_spec:
                self._decompress, self._out_codec = decompress_init(
                    frame.desc.color_spec, [Codec.UYVY, Codec.RGB], self.device
                )
                self._comp_codec = frame.desc.color_spec
            if self._decompress is None:
                return False
            decoded = self._decompress.decompress(frame, self._out_codec)
            if decoded is None:
                return False
        else:
            decoded = frame
        for c in self.clients:
            c.forward(decoded if c.compress is not None else frame)
        self.frames_forwarded += 1
        return True

    def run(self, frame_limit: Optional[int] = None, timeout: Optional[float] = None) -> int:
        with stream_context(self.stream):
            return self._run(frame_limit, timeout)

    def _run(self, frame_limit: Optional[int], timeout: Optional[float]) -> int:
        start = time.monotonic()
        while True:
            if frame_limit is not None and self.frames_forwarded >= frame_limit:
                break
            if timeout is not None and time.monotonic() - start > timeout:
                break
            pkts = self.session.recv_many(timeout=0.0001, max_pkts=256)
            now = time.monotonic()
            for pkt in pkts:
                self.pbuf.insert(pkt)
            self.pbuf.decode(now, self._handle)
            self.pbuf.remove_old(now)
        self.session.close()
        for c in self.clients:
            c.close()
        return self.frames_forwarded


def main(argv=None) -> int:
    argv, device = device_arg(argv if argv is not None else sys.argv[1:])
    if len(argv) < 2:
        print(
            "usage: hd_rum_translator <rx_port> [-c compress] host[:port] ... [--device cpu]",
            file=sys.stderr,
        )
        return 1
    rx_port = int(argv[0])
    clients: List[Tuple[str, int, str]] = []
    compress = "none"
    i = 1
    while i < len(argv):
        if argv[i] == "-c":
            compress = argv[i + 1]
            i += 2
            continue
        host, _, port = argv[i].partition(":")
        clients.append((host, int(port) if port else rx_port, compress))
        compress = "none"
        i += 1
    t = HdRumTranslator(rx_port, clients, device=device)
    log.notice(f"transcoding reflector on :{rx_port} -> {len(clients)} clients")
    t.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
