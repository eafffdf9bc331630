"""Sender pipeline: capture -> compress -> FEC -> RTP/UDP.

The port of ``ultragrid_tpu/pipeline/sender.py``.  Thread per stage like the
reference (capture thread src/main.cpp:347-397 -> compress
worker src/video_compress.cpp -> sender loop src/rxtx.cpp:259-287).

Threads and the card: the capture ring and the capture filters run on the
card, ``-c jpeg`` encodes there (kernel K1 and the entropy assembly) and
hands the send loop the file on the card, whose LDGM buffer the Tx builds
there; ``-c none`` hands it the frame on the card and :meth:`Tx.send_video`
copies it, or its LDGM buffer, to the host once.  Every thread that enqueues device work enters
the pipeline's one CUDA stream, the stream current where the sender was
built, so work handed from one thread to the next is ordered by the stream
itself (``device.pipeline_stream``, the rule of ``pipeline/loop.py``).

Audio (``-s``, ``-A``, ``-f A:``, ``-i``, ``-U``, ``--audio-host``) stays on
the host in numpy as in the reference: an audio thread reads the capture in
chunks of ``sample_rate // 25`` samples, or the audio embedded in a video
grab (``-s embedded``, as ``-I`` replays it) rides the capture thread, and
both send on the audio session at the base port + 2; only a Reed-Solomon
``-f A:rs:k:n`` parity product runs on the sender's device.  ``-E`` records
the frames as sent and, unlike the reference's sender, the audio as captured
(``sound.wav``; ROADMAP F8).

Standards mode (``--rtp-standard``) sends a JPEG frame as RFC 2435 on PT 26
(``Tx(rfc2435=True)``, kept across every ``Tx`` swap) and publishes an SDP
over HTTP (``utils/sdp.py``); ``--rtsp`` serves the session over RTSP
(``net/rtsp.py``), each client that PLAYs becoming an extra destination of
the RTP session.  Both servers default to port 8554: under ``--rtsp`` the
SDP server's bind fails and is logged, as in the reference (ROADMAP F10).
The port's sender closes both servers when it stops; the reference's leaves
them to the end of the process.
``echo`` (set by the duplex session for ``--echo-cancellation``) cleans the
captured audio before it is filtered and sent.

``-e`` (``encryption``) encrypts every video and audio packet
(``utils/crypto.PacketCrypto``, imported in the set-up as in the reference;
it raises where the package ``cryptography`` is missing).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ultragrid_tpu_torch.audio.capture import initialize_audio_capture
from ultragrid_tpu_torch.audio.codecs import get_audio_codec
from ultragrid_tpu_torch.audio.filters import ChannelRemap, ControlPortStats, make_audio_filter_chain
from ultragrid_tpu_torch.device import get_device, pipeline_stream, stream_context
from ultragrid_tpu_torch.modules.filters import FilterChain
from ultragrid_tpu_torch.modules.messaging import (
    Module,
    MsgChangeFec,
    MsgSender,
    RESPONSE_BAD_REQUEST,
    RESPONSE_OK,
    Response,
)
from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
from ultragrid_tpu_torch.modules.video_compress import CompressDriver
from ultragrid_tpu_torch.net.rtp import RtpSession
from ultragrid_tpu_torch.net.rtp_types import video_rtp_ts
from ultragrid_tpu_torch.net.rtsp import RtspServer
from ultragrid_tpu_torch.net.transmit import RATE_AUTO, Tx, parse_bitrate
from ultragrid_tpu_torch.ops.fec import fec_from_spec
from ultragrid_tpu_torch.utils import profiler
from ultragrid_tpu_torch.utils.control_socket import ControlServer
from ultragrid_tpu_torch.utils.crash import arm_exit_watchdog
from ultragrid_tpu_torch.utils.export import Exporter
from ultragrid_tpu_torch.utils.keyboard import KeyboardControl
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.params import add_to_param, get_commandline_param, param_is_set
from ultragrid_tpu_torch.utils.sdp import SdpHttpServer, make_sdp
from ultragrid_tpu_torch.utils.tiling import VideoMode, vf_split

add_to_param("fec-adaptive",
             "[=max_pct] adapt LDGM protection to RTCP-RR receiver loss "
             "(2x worst loss, decay when clean; sender-side, beyond the "
             "reference's display-only RR use, rtp.c:160-201)")

log = Logger("sender")


class VideoSender:
    def __init__(
        self,
        capture_spec: str,
        host: str,
        compress_spec: str = "none",
        fec_spec: str = "none",
        tx_port: int = 5004,
        rx_port: int = 0,
        mtu: int = 1500,
        frame_limit: Optional[int] = None,
        capture_filter: str = "",
        audio_capture: Optional[str] = None,
        audio_codec: str = "PCM",
        record: Optional[str] = None,
        mode: str = "normal",
        rtp_standard: bool = False,
        rtsp: bool = False,
        control_port: Optional[int] = None,
        audio_fec: str = "none",
        audio_channel_map: Optional[str] = None,
        audio_filter: Optional[str] = None,
        start_paused: bool = False,
        bitrate: int = RATE_AUTO,
        bitrate_fixed: bool = False,
        ttl: int = 255,
        force_ip_version: int = 0,
        mcast_if=None,
        audio_host: Optional[str] = None,
        encryption: Optional[str] = None,
        device="cuda",
    ):
        self.device = get_device(device)
        self.stream = pipeline_stream(self.device)
        self.mode = VideoMode.from_str(mode)
        self.exporter = Exporter(record or None) if record is not None else None
        self.capture_chain = FilterChain(capture_filter)
        self.capture = initialize_video_capture(capture_spec, device=self.device)
        self.audio = None
        self.audio_codec_name = audio_codec
        self.audio_fec = audio_fec
        # audio filter chain: -U remap first, then --audio-filter elements
        # (ref: --audio-filter grammar, main.cpp:271)
        self.audio_filters = []
        if audio_channel_map:
            self.audio_filters.append(ChannelRemap(audio_channel_map))
        if audio_filter:
            self.audio_filters.extend(make_audio_filter_chain(audio_filter))
        # "embedded" = audio rides along with video capture grabs
        # (ref: audio_sdi_send, main.cpp:365)
        self.audio_embedded = audio_capture == "embedded"
        self.audio_session = None
        if audio_capture and audio_capture != "none":
            if not self.audio_embedded:
                self.audio = initialize_audio_capture(audio_capture)
            self.audio_codec = get_audio_codec(audio_codec)
            # audio ports = base + 2 (ref: src/main.cpp:592-628); --audio-host
            # redirects the audio stream (ref: OPT_AUDIO_HOST, main.cpp:895)
            self.audio_session = RtpSession(addr=audio_host or host, rx_port=0,
                                            tx_port=tx_port + 2, mtu=mtu,
                                            ttl=ttl,
                                            force_ip_version=force_ip_version)
            self.audio_tx = Tx(mtu=mtu, device=self.device)
        self.root = Module("root")
        # live-reconfigurable sender module (ref: the "sender" message
        # target, rxtx/rtp_common.c:216-241 + msg_sender handling)
        self.sender_module = Module("sender", self.root)
        self.sender_module.msg_callback = self._on_sender_message
        self.paused = threading.Event()
        if start_paused:
            self.paused.set()
        self.compress = CompressDriver(compress_spec, self.sender_module, self.device, self.stream)
        if bitrate > 0:
            # a fixed -l rate also constrains the own-codec paths (the
            # reference reaches rate-targeted video only through its lavc
            # wrapper, src/video_compress/libavcodec.cpp:943-1003)
            impl = self.compress.impl
            if hasattr(impl, "set_target_bitrate"):
                impl.set_target_bitrate(bitrate)
        # RTCP always on like the reference (rtp_init starts RTCP on the
        # odd port; RR feedback feeds stats + adaptive FEC)
        self.session = RtpSession(addr=host, rx_port=rx_port, tx_port=tx_port,
                                  mtu=mtu, ttl=ttl, rtcp=True,
                                  force_ip_version=force_ip_version,
                                  mcast_if=mcast_if)
        self.crypto = None
        if encryption:
            from ultragrid_tpu_torch.utils.crypto import PacketCrypto

            self.crypto = PacketCrypto(encryption)
        if self.crypto is not None and self.audio_session is not None:
            # audio rides the same per-packet AES (PT 25/36)
            self.audio_tx.encryption = self.crypto
        self.rfc2435 = rtp_standard
        self.tx = self._new_tx(fec_spec, mtu, bitrate, bitrate_fixed)
        self.sdp_server = None
        self.rtsp_server = None
        if rtsp:
            # serve the session over RTSP: PLAY adds the client as an RTP
            # destination (ref: rtsp rxtx mode / BasicRTSPOnlyServer.cpp)
            try:
                self.rtsp_server = RtspServer(
                    [("video", tx_port, 26, "JPEG", 90000)],
                    on_play=self.session.add_destination,
                    on_teardown=self.session.remove_destination,
                )
            except OSError as exc:
                log.warning(f"RTSP server unavailable: {exc}")
        if rtp_standard:
            # publish an SDP for the standards-mode stream (ref: utils/sdp.c)
            sdp = make_sdp(host or "0.0.0.0", [("video", tx_port, 26, "JPEG", 90000)])
            try:
                self.sdp_server = SdpHttpServer(sdp)
            except OSError as exc:
                log.warning(f"SDP HTTP server unavailable: {exc}")
        self.frame_limit = frame_limit
        self.should_exit = threading.Event()
        self.frames_sent = 0
        # --echo-cancellation: assigned by the duplex session runner; the
        # captured (near-end) signal is cleaned before compression
        # (ref: echo_cancel, audio/echo.cpp)
        self.echo = None
        # runtime control socket — live sessions always get one like the
        # reference (ref: control_init, main.cpp:1288-1306)
        self.control = None
        if control_port is not None:
            try:
                self.control = ControlServer(self.root, control_port)
                log.notice(f"control socket on 127.0.0.1:{self.control.port}")
                for flt in self.audio_filters:
                    if isinstance(flt, ControlPortStats) and flt.control is None:
                        flt.control = self.control
            except OSError as e:
                log.warning(f"control socket unavailable: {e}")
        self._bytes_since_report = 0
        self._last_report = time.monotonic()
        self._adaptive_pct = 0.0
        self._applied_pct = 0.0

    def _new_tx(self, fec_spec: str, mtu: int, bitrate: int, bitrate_fixed: bool) -> Tx:
        return Tx(mtu=mtu, fec_spec=fec_spec, bitrate=bitrate, bitrate_fixed=bitrate_fixed,
                  encryption=self.crypto, rfc2435=self.rfc2435, device=self.device)

    def _swap_tx(self, fec_spec: str) -> None:
        """Single-reference swap: the next frame uses the new Tx."""
        self.tx = self._new_tx(fec_spec, self.tx.mtu, self.tx.bitrate, self.tx.bitrate_fixed)

    def _maybe_adapt_fec(self) -> None:
        """Loss-adaptive LDGM protection driven by RTCP RR feedback
        (opt-in via ``--param fec-adaptive[=max_pct]``).  The reference only
        *displays* RR loss (rtp.c:160-201); here the sender raises the LDGM
        percentage toward 2x the worst receiver-reported loss and decays it
        slowly when the path recovers, swapping Tx atomically like a
        control-socket ``fec`` command."""
        if not param_is_set("fec-adaptive"):
            return
        max_pct = float(get_commandline_param("fec-adaptive") or 50.0)
        worst = 0.0
        for rr in self.session.rtcp.remote_reports.values():
            if rr.get("type") == "RR":
                worst = max(worst, rr.get("fraction_lost", 0.0))
        cur = self._adaptive_pct
        target = min(worst * 100.0 * 2.0, max_pct)
        if target > cur:
            new = target  # raise immediately on observed loss
        else:
            new = max(target, cur * 0.9)  # decay ~10%/s when clean
        if new < 1.0:
            new = 0.0
        self._adaptive_pct = new
        applied = self._applied_pct
        # reswap Tx only on meaningful change (>=2 points or on/off flip)
        if abs(new - applied) < 2.0 and (new > 0.0) == (applied > 0.0):
            return
        self._applied_pct = new
        spec = f"ldgm:{max(new, 1.0):.0f}%" if new >= 1.0 else "none"
        self._swap_tx(spec)
        log.notice(f"adaptive FEC -> {spec} "
                   f"(worst receiver loss {worst * 100:.1f}%)")
        if self.control is not None:
            self.control.report_stats(f"fec_adapt {spec} loss {worst:.4f}")

    def _on_sender_message(self, msg) -> Response:
        """Runtime reconfig from the control socket / keyboard
        (ref: fec change rtp_common.c:216-241; msg_sender receiver/port/
        pause, src/video_rxtx/ultragrid_rtp.cpp message handling)."""
        if isinstance(msg, MsgChangeFec):
            spec = msg.fec.strip()
            # strip an optional V: medium prefix (ref: main.cpp:824-839)
            if spec[:2].upper() == "V:":
                spec = spec[2:]
            try:
                if spec not in ("", "none") and not spec.startswith("mult:"):
                    fec_from_spec(spec, 65536, self.tx.mtu)  # validate
            except Exception as e:  # noqa: BLE001 - reported to the sender of the message
                return Response(RESPONSE_BAD_REQUEST, f"bad fec {spec!r}: {e}")
            self._swap_tx(spec)
            log.notice(f"FEC changed to {spec or 'none'}")
            return Response(RESPONSE_OK)
        if isinstance(msg, MsgSender):
            if msg.receiver is not None:
                try:
                    self.session.set_receiver(msg.receiver)
                except (ValueError, OSError) as e:
                    return Response(RESPONSE_BAD_REQUEST, str(e))
                log.notice(f"receiver changed to {msg.receiver}")
            if msg.port is not None:
                addr = self.session._dest[0] if self.session._dest else None
                if addr is None:
                    return Response(RESPONSE_BAD_REQUEST, "no receiver set")
                self.session.set_receiver(addr, msg.port)
                log.notice(f"TX port changed to {msg.port}")
            if msg.paused is not None:
                if msg.paused:
                    self.paused.set()
                else:
                    self.paused.clear()
                log.notice("paused" if msg.paused else "playing")
            return Response(RESPONSE_OK)
        return Response(RESPONSE_BAD_REQUEST, "unsupported message")

    def _capture_thread(self) -> None:
        count = 0
        fps_t0 = time.monotonic()
        fps_n = 0
        try:
            with stream_context(self.stream):
                while not self.should_exit.is_set():
                    if self.frame_limit is not None and count >= self.frame_limit:
                        break
                    with profiler.zone("capture.grab"):
                        frame, audio = self.capture.grab()
                    # stamp the capture instant (ref: main.cpp captures carry
                    # a timestamp into the RTP TS via tv_to_rtp); transmit
                    # maps this to the 90 kHz RTP clock, so a same-host
                    # receiver can measure capture->display latency against
                    # time.monotonic()
                    if frame is not None and frame.timestamp < 0:
                        frame.timestamp = time.monotonic()
                    if self.audio_embedded and audio is not None:
                        # embedded (SDI-style) audio rides the capture cadence
                        # (ref: audio_sdi_send, main.cpp:365)
                        self._send_audio(audio)
                    if frame is not None:
                        with profiler.zone("capture.filter"):
                            frame = self.capture_chain.apply(frame)
                    if frame is None:
                        if self.capture.finished:
                            break  # a replayed recording at its end (ROADMAP F9)
                        continue
                    if self.paused.is_set():
                        continue  # drop while paused (ref: paused sender state)
                    # periodic per-stage FPS line (ref: print_fps, main.cpp:307-332)
                    fps_n += 1
                    now = time.monotonic()
                    if now - fps_t0 >= 5.0:
                        log.notice(f"[capture] {fps_n} frames in {now - fps_t0:.2f} s "
                                   f"({fps_n / (now - fps_t0):.2f} fps)")
                        fps_t0, fps_n = now, 0
                    if self.mode.x * self.mode.y > 1:
                        frame = vf_split(frame, self.mode.x, self.mode.y)
                    count += 1
                    self.compress.enqueue(frame)
        finally:
            self.compress.enqueue(None)

    def _send_audio(self, frame) -> None:
        """Filter, record, compress and send one captured audio frame: one
        RTP buffer per codec packet (ref compress loop, audio.cpp:774-779)."""
        for flt in self.audio_filters:
            frame = flt.apply(frame)
            if frame is None:
                return
        if self.exporter is not None:
            self.exporter.export_audio(frame)
        for comp in self.audio_codec.compress_multi(frame):
            self.audio_tx.send_audio(self.audio_session, comp, self.audio_codec_name,
                                     fec_spec=self.audio_fec)

    def _audio_thread(self) -> None:
        # ~1/25 s chunks; pacing is TIMESTAMP-driven off the cumulative
        # sample count, not a fixed sleep, so capture drift (48001 Hz
        # sources, slow reads) never desynchronizes the stream
        # (ref: audio_sender_thread cadence, audio.cpp:707-776)
        chunk = self.audio.desc.sample_rate // 25
        start = time.monotonic()
        samples_sent = 0
        with stream_context(self.stream):  # -f A:rs parity on the device
            while not self.should_exit.is_set():
                frame = self.audio.read(chunk)
                if frame is None:
                    break
                # pacing advances by CAPTURED samples even if a filter drops
                nsamples = frame.channels[0].size // frame.desc.bps
                if self.echo is not None:
                    frame = self.echo.cancel(frame) or frame
                self._send_audio(frame)
                samples_sent += nsamples
                deadline = start + samples_sent / frame.desc.sample_rate
                delay = deadline - time.monotonic()
                if delay > 0:
                    time.sleep(delay)

    def _report(self, sent_bytes: int) -> None:
        """Periodic bandwidth and RTCP lines on the control socket (ref:
        report_stats, transmit.c:625-648; RR consumption rtp.c:160-201)."""
        self._bytes_since_report += sent_bytes
        now = time.monotonic()
        if now - self._last_report < 1.0:
            return
        self.control.report_stats(f"tx_send {self.session.ssrc:x} video {self._bytes_since_report}")
        for ssrc, rr in self.session.rtcp.remote_reports.items():
            if rr.get("type") != "RR":
                continue
            self.control.report_stats(
                f"rtcp_rr {ssrc:x} lost {rr.get('lost', 0)} "
                f"fraction {rr.get('fraction_lost', 0.0):.4f} "
                f"jitter {rr.get('jitter', 0)}")
            log.info(f"receiver {ssrc:x} reports {rr.get('lost', 0)} lost "
                     f"({rr.get('fraction_lost', 0.0) * 100:.1f}%)")
        self._maybe_adapt_fec()
        self._last_report = now
        self._bytes_since_report = 0

    def run(self) -> int:
        kb = KeyboardControl(self.root, on_exit=self.should_exit.set)
        kb.start()  # no-op unless stdin is a tty
        t = threading.Thread(target=self._capture_thread, name="capture", daemon=True)
        t.start()
        at = None
        if self.audio is not None:
            at = threading.Thread(target=self._audio_thread, name="audio", daemon=True)
            at.start()
        with stream_context(self.stream):
            while True:
                frame = self.compress.pop()
                if frame is None:
                    break
                key = video_rtp_ts(frame.timestamp) if frame.timestamp >= 0 else None
                if frame.compress_end:
                    profiler.interval("send.queue", int(frame.compress_end * 1e9), key)
                if self.exporter is not None:
                    self.exporter.export_video(frame)
                with profiler.zone("fec+tx.send", frame=key):
                    before = self.session.bytes_sent
                    self.tx.send_video(self.session, frame)
                self.frames_sent += 1
                if self.control is not None:
                    self._report(self.session.bytes_sent - before)
        self.should_exit.set()
        # force-exit if a stuck device/capture thread wedges the shutdown
        # (ref: main.cpp:1438 exit watchdog)
        wd = arm_exit_watchdog()
        if self.control is not None:
            self.control.close()
        for srv in (self.rtsp_server, self.sdp_server):
            if srv is not None:
                srv.close()
        t.join(timeout=5)
        if at is not None:
            at.join(timeout=5)
            self.audio.done()
        if self.audio_session is not None:
            self.audio_session.close()
        self.session.close()
        if self.exporter is not None:
            self.exporter.finish()
        self.capture.done()
        wd.cancel()
        return self.frames_sent


def run_sender(args) -> int:
    bitrate, bitrate_fixed = parse_bitrate(args.limit_bitrate)
    sender = VideoSender(
        capture_spec=args.capture,
        host=args.host,
        compress_spec=args.compress,
        fec_spec=args.fec,
        tx_port=int(str(args.ports).split(":")[0]),
        mtu=args.mtu,
        frame_limit=args.frames,
        capture_filter=args.capture_filter,
        audio_capture=args.audio_capture,
        audio_codec=args.audio_codec,
        record=args.record,
        mode=args.mode,
        control_port=args.control_port,
        audio_fec=args.audio_fec,
        audio_channel_map=args.audio_channel_map,
        audio_filter=args.audio_filter,
        start_paused=args.start_paused,
        bitrate=bitrate,
        bitrate_fixed=bitrate_fixed,
        ttl=args.ttl if args.ttl >= 0 else 255,
        force_ip_version=args.force_ip_version,
        mcast_if=args.mcast_if,
        audio_host=args.audio_host,
        rtp_standard=args.rtp_standard,
        rtsp=args.rtsp,
        encryption=args.encryption,
        device=args.device,
    )
    n = sender.run()
    log.notice(f"sent {n} frames")
    return 0
