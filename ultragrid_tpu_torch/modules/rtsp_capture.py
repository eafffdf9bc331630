"""RTSP receive-client capture module.

The port of ``ultragrid_tpu/modules/rtsp_capture.py`` (ref:
src/video_capture/rtsp.c — RTSP client + RTP depacketization feeding the
pipeline as a capture device).  Config grammar mirrors the reference:

    -t rtsp:rtsp://host[:port]/path[:decompress=uyvy|rgb|no]

The client DESCRIBEs the session, SETUPs the first video media on a local
UDP port pair, PLAYs, and depacketizes RTP into frames: RFC 2435 JPEG
(PT 26) and RFC 6184 H.264 are supported — the same payloads the port's
sender emits in standards mode, and what an IP camera sends.  Frames are
decoded to raw pixels on the capture's device by default, through
``decompress_init``: JPEG by ``JpegDecompress`` (host scan decode, the rest
on the card), H.264 by ``OwnH264Decompress`` first, as the reference's
``decompress_init`` orders it; a stream outside the own decoder's envelope,
and H.264 to RGB, go to libavcodec where it is present.  Where no module
gives the output, the compressed frames pass through with an error, as in
the reference.  ``decompress=no`` passes the compressed frames through.

The rx thread only reads and depacketizes: it hands every access unit, in
order, to a decode thread, and never waits on a decode, so a camera faster
than the decoder loses no datagram (the reference decodes on its rx thread,
which then overruns the socket).  No access unit is dropped on the way, since
a P frame needs the one before it; only the queue of decoded frames keeps
the latest (a camera that stays faster than the decoder makes the queue of
access units grow, and the frames lag).  The decode thread enters the
capture's stream (the stream current where the capture was built).  The
RTP socket still asks for the session's receive buffer (``RECV_BUF``).
"""

from __future__ import annotations

import base64
import queue
import socket
import threading
import time
from typing import Optional, Tuple

import numpy as np

from ultragrid_tpu_torch.device import pipeline_stream, stream_context
from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
from ultragrid_tpu_torch.modules.video_capture import VideoCapture
from ultragrid_tpu_torch.modules.video_decompress import decompress_init
from ultragrid_tpu_torch.net.rtpdec_h264 import NAL_PPS, NAL_SPS, H264Depacketizer, nal_type
from ultragrid_tpu_torch.net.rtpdec_jpeg import JpegDepacketizer
from ultragrid_tpu_torch.net.rtsp_client import RtspClient
from ultragrid_tpu_torch.ops.jpeg import _parse_headers
from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("vidcap.rtsp")


# the receive buffer the port's RtpSession asks for (net/rtp.py; ref:
# doc/PERFORMANCE-TUNING.md:18-22): a 1080p JPEG frame is about 30
# datagrams, an H.264 IDR 145
RECV_BUF = 4 * 1024 * 1024


def _rtp_socket() -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, RECV_BUF)
    except OSError:
        pass
    return s


def _bind_even_udp() -> Tuple[socket.socket, int]:
    """Bind a UDP socket on an even ephemeral port (RTP convention), with
    the session's receive buffer."""
    for _ in range(64):
        s = _rtp_socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        if port % 2 == 0:
            return s, port
        even = port - 1 if port % 2 else port
        s2 = _rtp_socket()
        try:
            s2.bind(("", even))
            s.close()
            return s2, even
        except OSError:
            s2.close()
            s.close()
    raise OSError("could not bind an even RTP port")


class RtspCapture(VideoCapture):
    """RTSP client capture device (video track)."""

    def __init__(self, cfg: str, device="cuda"):
        super().__init__(cfg, device)
        self.stream = pipeline_stream(self.device)
        self.decode_failures = 0
        url = None
        self.decompress = "uyvy"
        toks = [t for t in cfg.split(":") if t]
        url_parts = []
        for tok in toks:
            if "=" in tok and not tok.startswith("//"):
                k, _, v = tok.partition("=")
                if k == "decompress":
                    self.decompress = v.lower()
                    continue
            url_parts.append(tok)
        if url_parts:
            url = ":".join(url_parts)
        if not url or not url.startswith("rtsp://"):
            raise ValueError(
                "usage: rtsp:rtsp://host[:port]/path[:decompress=uyvy|rgb|no]"
            )

        self.client = RtspClient(url)
        medias = self.client.describe()
        video = next((m for m in medias if m.kind == "video"), None)
        if video is None:
            raise ValueError(f"no video media in RTSP session {url}")
        self.media = video
        self.sock, self.rtp_port = _bind_even_udp()
        self.sock.settimeout(0.25)
        self.client.setup(video, self.rtp_port)
        self.client.play()
        log.notice(
            f"playing {url}: {video.encoding} PT {video.payload_type} "
            f"-> local RTP port {self.rtp_port}"
        )

        if video.encoding == "JPEG":
            self._depack = JpegDepacketizer()
            self._codec = Codec.JPEG
        elif video.encoding in ("H264", "H.264"):
            self._depack = H264Depacketizer()
            self._codec = Codec.H264
            props = self.media.fmtp.get("sprop-parameter-sets", "")
            if props:
                for b64 in props.split(","):
                    try:
                        nal = base64.b64decode(b64 + "=" * (-len(b64) % 4))
                    except Exception:
                        continue
                    if nal and nal_type(nal[0]) == NAL_SPS:
                        self._depack.sps = nal
                    elif nal and nal_type(nal[0]) == NAL_PPS:
                        self._depack.pps = nal
        else:
            raise ValueError(f"unsupported RTSP video encoding {video.encoding!r}")

        self._decomp = None
        self._out_codec = None
        self._frames: "queue.Queue[VideoFrame]" = queue.Queue(maxsize=4)
        # every access unit in arrival order, then None at the end of the stream
        self._aus: "queue.Queue[Optional[bytes]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._rx_loop, name="rtsp-rx", daemon=True)
        self._decoder = threading.Thread(target=self._decode_loop, name="rtsp-decode", daemon=True)
        self._thread.start()
        self._decoder.start()

    # -- RTP receive ------------------------------------------------------

    def _rx_loop(self) -> None:
        try:
            self._rx_packets()
        finally:
            self._aus.put(None)

    def _rx_packets(self) -> None:
        while not self._stop.is_set():
            try:
                data, _ = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if len(data) < 12 or (data[0] >> 6) != 2:
                continue
            pt = data[1] & 0x7F
            marker = bool(data[1] & 0x80)
            cc = data[0] & 0xF
            off = 12 + 4 * cc
            if data[0] & 0x10:  # extension
                if len(data) < off + 4:
                    continue
                ext_len = int.from_bytes(data[off + 2 : off + 4], "big")
                off += 4 + 4 * ext_len
            if pt != self.media.payload_type or len(data) <= off:
                continue
            out = self._depack.feed(data[off:], marker)
            if out is not None:
                self._aus.put(bytes(out))

    def _decode_loop(self) -> None:
        with stream_context(self.stream):
            while True:
                payload = self._aus.get()
                if payload is None or self._stop.is_set():
                    return
                frame = self._to_frame(payload)
                if frame is None:
                    continue
                try:
                    self._frames.put_nowait(frame)
                except queue.Full:  # drop oldest: live source, latest wins
                    try:
                        self._frames.get_nowait()
                        self._frames.put_nowait(frame)
                    except queue.Empty:
                        pass

    def _to_frame(self, payload: bytes) -> Optional[VideoFrame]:
        data = np.frombuffer(payload, dtype=np.uint8)
        if self._codec == Codec.JPEG:
            # dimensions ride in the JPEG headers; depacketizer rebuilt them
            try:
                hdr = _parse_headers(payload)
                w, h = hdr["w"], hdr["h"]
            except Exception:
                return None
        else:
            w = h = 0  # parsed by the decoder below
        desc = VideoDesc(width=w, height=h, color_spec=self._codec, fps=30.0)
        frame = VideoFrame(desc, [data], timestamp=time.time())
        if self.decompress in ("no", "none"):
            return frame
        out_codec = Codec.RGB if self.decompress == "rgb" else Codec.UYVY
        if self._decomp is None:
            self._decomp, self._out_codec = decompress_init(self._codec, [out_codec], self.device)
            if self._decomp is None:
                log.error(f"no decompressor for {self._codec.name} -> {out_codec.name} (libavcodec absent); "
                          "passing the compressed frames through")
                self.decompress = "no"
                return frame
        try:
            return self._decomp.decompress(frame, self._out_codec)
        except Exception as exc:  # noqa: BLE001 — corrupted stream data must not kill rx
            self.decode_failures += 1
            log.warning(f"decode failed: {exc}")
            return None

    # -- capture API ------------------------------------------------------

    def grab(self):
        try:
            return self._frames.get(timeout=0.5), None
        except queue.Empty:
            return None, None

    def done(self) -> None:
        self._stop.set()
        try:
            self.client.teardown()
        except Exception:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
        self._decoder.join(timeout=2.0)


register_module("rtsp", LibraryClass.VIDEO_CAPTURE, RtspCapture)
