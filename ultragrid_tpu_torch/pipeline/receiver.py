"""Receiver pipeline: RTP/UDP -> playout buffer -> FEC -> decompress -> display.

The port of ``ultragrid_tpu/pipeline/receiver.py``: the reference's receiver
thread and 3-stage decode pipeline (ref:
src/rxtx/ultragrid_rtp.c:382-500, src/rtp/video_decoders.cpp:46-93).

Threads and the card: the rx loop reassembles packets on the host (and fills
a display-owned framebuffer on the card with one upload), the fec thread
runs the LDGM peel on the card with ``--param ldgm-device=device``, and the
decompress thread uploads each frame once (a JPEG decoder uploads its own
scan-decoded arrays) and decodes, converts, postprocesses and displays on
the card.  Every thread enters the pipeline's one CUDA stream, the stream
current where the receiver was built (the rule of ``pipeline/loop.py``).

Audio (``-r``) is received on the base port + 2 by the same rx loop into its
own playout buffer and decoded, Reed-Solomon erasures included, scaled
(``--audio-scale``, runtime volume and mute) and played on the host in numpy,
as in the reference; ``--audio-delay`` sets the two playout delays.  In a
full-duplex session with ``--echo-cancellation`` each played frame also
feeds the sender's echo canceller (``echo``).

The standards payloads (RFC 2435 JPEG on PT 26, RFC 6184 H.264 on PT 96)
take the Python playout-buffer path; their frames are decoded on the card
like any compressed frame.

``-e`` (``encryption``) decrypts the encrypted payload types of video and
audio (``utils/crypto.PacketCrypto``, imported in the set-up as in the
reference).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ultragrid_tpu_torch.audio.playback import initialize_audio_playback
from ultragrid_tpu_torch.audio.types import AudioFrame
from ultragrid_tpu_torch.audio.volume import format_stats_line
from ultragrid_tpu_torch.device import get_device, pipeline_stream, stream_context
from ultragrid_tpu_torch.modules.filters import FilterChain
from ultragrid_tpu_torch.modules.messaging import (
    RESPONSE_BAD_REQUEST,
    RESPONSE_OK,
    Module,
    MsgReceiver,
    Response,
)
from ultragrid_tpu_torch.modules.video_decompress import decompress_init
from ultragrid_tpu_torch.modules.video_display import initialize_video_display
from ultragrid_tpu_torch.net.audio_rx import AudioRxState
from ultragrid_tpu_torch.net.pbuf import PlayoutBuffer
from ultragrid_tpu_torch.net.rtp import RtpSession
from ultragrid_tpu_torch.net.rtp_types import received_rtp_ts
from ultragrid_tpu_torch.net.video_rx import FecJob, VideoRxState
from ultragrid_tpu_torch.net.vrx_fast import FastVideoRx
from ultragrid_tpu_torch.ops import pixfmt
from ultragrid_tpu_torch.types import Codec, VideoFrame, is_codec_opaque
from ultragrid_tpu_torch.utils import profiler
from ultragrid_tpu_torch.utils.control_socket import ControlServer
from ultragrid_tpu_torch.utils.keyboard import KeyboardControl
from ultragrid_tpu_torch.utils.log import Logger
from ultragrid_tpu_torch.utils.params import add_to_param, get_commandline_param
from ultragrid_tpu_torch.utils.tiling import VideoMode, vf_merge_tiles

add_to_param("pbuf-delay",
             "<ms> playout (jitter) buffer delay, default 32 "
             "(ref: --param pbuf-delay, pbuf.c:191)")
add_to_param("vrx-fast",
             "* vrx-fast={auto|off}\n"
             "  C fast-path video depacketizer (default auto: the C path, "
             "which must build; off: the Python pbuf path)")

log = Logger("receiver")


def _frame_key(item) -> Optional[int]:
    """The RTP timestamp of a FEC job or a received frame: the key of its
    spans (None where unknown)."""
    if isinstance(item, FecJob):
        return item.rtp_ts if item.rtp_ts >= 0 else None
    return received_rtp_ts(item.timestamp) if item.timestamp >= 0 else None


def _put(q: "queue.Queue", item, name: str) -> None:
    """Hand ``item`` to the next stage's queue with the instant of the put
    (its ``<name>.queue`` span runs from here to the stage's ``get``); a
    queue still full after 1 s drops the frame, marked ``rx.drop``."""
    try:
        q.put((item, time.monotonic_ns()), timeout=1.0)
    except queue.Full:
        profiler.instant("rx.drop", _frame_key(item), {"queue": name})
        raise


class VideoReceiver:
    def __init__(
        self,
        display_spec: str,
        rx_port: int = 5004,
        frame_limit: Optional[int] = None,
        timeout: Optional[float] = None,
        playout_delay: float = 0.032,
        audio_delay_ms: int = 0,
        postprocess: str = "",
        audio_playback: Optional[str] = None,
        mode: str = "normal",
        control=None,
        mcast_addr: Optional[str] = None,
        force_ip_version: int = 0,
        root: Optional[Module] = None,
        mcast_if: Optional[str] = None,
        audio_scale: Optional[str] = None,
        encryption: Optional[str] = None,
        device="cuda",
    ):
        if audio_scale not in (None, "", "none", "auto"):
            float(audio_scale)  # fail fast on '--audio-scale 50%' typos
        self.audio_scale = audio_scale
        self.volume = 1.0  # runtime audio gain (control socket / keyboard)
        self.muted = False
        # --echo-cancellation: assigned by the duplex runner (far-end feed)
        self.echo = None
        self._agc_gain = 1.0
        self.device = get_device(device)
        self.stream = pipeline_stream(self.device)
        self.control = control
        if root is not None:
            # live-reconfigurable receiver module (ref: receiver-side
            # messages, e.g. runtime postprocess change via the control socket)
            self._module = Module("receiver", root)
            self._module.msg_callback = self._on_message
        self.mode = VideoMode.from_str(mode)
        self.postprocess_chain = FilterChain(postprocess)
        self.display = initialize_video_display(display_spec, device=self.device)
        # a multicast session address makes the receiver join the group
        # (ref: session addr semantics, net_udp.c udp_join_mcast_grp)
        self.session = RtpSession(addr=mcast_addr, rx_port=rx_port, tx_port=0,
                                  rtcp=True,  # RR feedback to the sender
                                  force_ip_version=force_ip_version,
                                  mcast_if=mcast_if)
        # --param pbuf-delay=<ms> overrides the 32 ms default
        # (ref: pbuf.c:191 + the pbuf-delay param)
        pd = get_commandline_param("pbuf-delay")
        if pd is not None:
            playout_delay = float(pd) / 1000.0
        self._base_playout = playout_delay
        self.audio_playback = None
        if audio_playback and audio_playback != "none":
            self.audio_playback = initialize_audio_playback(audio_playback)
            self.audio_session = RtpSession(addr=mcast_addr, rx_port=rx_port + 2, tx_port=0,
                                            force_ip_version=force_ip_version)
            # --audio-delay: positive delays audio, negative delays video
            # (ref: set_audio_delay host.cpp:1019-1024 -> per-medium playout
            # offsets, rtp_common.c:320-321)
            self.audio_pbuf = PlayoutBuffer(playout_delay + max(audio_delay_ms, 0) / 1000.0)
            self.audio_rx = AudioRxState()
            self._audio_desc = None
        self.pbuf = PlayoutBuffer(playout_delay + max(-audio_delay_ms, 0) / 1000.0)
        crypto = None
        if encryption:
            from ultragrid_tpu_torch.utils.crypto import PacketCrypto

            crypto = PacketCrypto(encryption)
        self.rx_state = VideoRxState(device=self.device, decryption=crypto)
        if self.audio_playback is not None:
            self.audio_rx.decryption = crypto
        self.frame_limit = frame_limit
        self.timeout = timeout
        self.should_exit = False  # external stop (embedding, keyboard 'q')
        # set before run(): each frame the C fast path takes without FEC
        # carries the arrival of its last datagram as
        # callbacks["last_arrival"] (tools/bench_receiver.py)
        self.stamp_last_arrival = False
        self.frames_displayed = 0
        self._decompress = None
        self._decomp_out: Optional[Codec] = None
        self._comp_codec: Optional[Codec] = None
        self._decoder = None
        self._decoder_out: Optional[Codec] = None
        self._conv_in: Optional[Codec] = None
        self._display_desc = None

    def _on_message(self, msg) -> Response:
        if not isinstance(msg, MsgReceiver):
            return Response(RESPONSE_BAD_REQUEST, "unsupported message")
        if msg.postprocess is not None:
            try:
                chain = FilterChain(msg.postprocess)
            except Exception as e:  # noqa: BLE001 - reported to the sender of the message
                return Response(RESPONSE_BAD_REQUEST, str(e))
            self.postprocess_chain = chain  # atomic swap
            log.notice(f"postprocess changed to {msg.postprocess or 'none'}")
        if msg.volume is not None:
            # ref: volume/mute control commands + keyboard keys
            v = msg.volume
            if v == "mute":
                self.muted = True
            elif v == "unmute":
                self.muted = False
            elif v == "toggle-mute":  # keyboard 'm'
                self.muted = not self.muted
            elif v == "up":
                self.volume *= 10 ** (1 / 20)  # +1 dB
            elif v == "down":
                self.volume /= 10 ** (1 / 20)
            else:
                try:
                    self.volume = float(v)
                except ValueError:
                    return Response(RESPONSE_BAD_REQUEST, f"bad volume {v!r}")
            log.notice(f"volume {self.volume:.3f}{' (muted)' if self.muted else ''}")
        if msg.av_delay_ms is not None:
            # ref: av-delay command -> per-medium playout offsets
            d = msg.av_delay_ms
            self.pbuf.playout_delay = self._base_playout + max(-d, 0) / 1000.0
            if self.audio_playback is not None:
                self.audio_pbuf.playout_delay = self._base_playout + max(d, 0) / 1000.0
            log.notice(f"av-delay {d} ms")
        return Response(RESPONSE_OK)

    # -- stage 1: packet reassembly (runs on the rx thread) ---------------

    def _framebuffer_provider(self, desc):
        """Display-owned framebuffer for the LINE_DECODER path: only when
        the display accepts the network codec natively and no postprocess /
        tile merge sits between (ref: video_decoders.cpp:1707-1796)."""
        if (is_codec_opaque(desc.color_spec)
                or desc.tile_count > 1
                or self.mode.x * self.mode.y > 1
                or self.postprocess_chain.filters
                or desc.color_spec not in self.display.get_property_codecs()):
            return None
        if self._display_desc != desc:
            self.display.reconfigure(desc)
            self._display_desc = desc
        return self.display.get_frame()

    def _reassemble_cb(self, node) -> bool:
        """pbuf decode callback: stage-1 reassembly only, then hand off to
        the fec thread (ref: decode_video_frame -> fec_queue push,
        video_decoders.cpp:1862)."""
        # the frame's wait in the playout buffer, from its first datagram
        profiler.interval("rx.playout", int(node.arrival * 1e9), node.ts)
        with profiler.zone("rx.reassemble", frame=node.ts):
            out = self.rx_state.reassemble(node)
        if out is None:
            return False
        self._hand_off(out)
        return True

    def _hand_off(self, out) -> None:
        try:
            _put(self._fec_q, out, "fec")
        except queue.Full:
            # the reference warns "your computer may be too slow" when the
            # decode pipeline cannot keep up (video_decoders.cpp:1845-1867)
            log.warning("decode pipeline too slow, dropping frame")

    # -- stage 2: FEC thread ---------------------------------------------

    def _fec_thread(self) -> None:
        with stream_context(self.stream):
            while True:
                item = self._fec_q.get()
                if item is None:
                    self._decomp_q.put(None)
                    return
                job, t_put = item
                key = _frame_key(job)
                profiler.interval("fec.queue", t_put, key)
                if isinstance(job, FecJob):
                    with profiler.zone("rx.fec", frame=key):
                        frame = self.rx_state.decode_fec_job(job)
                    if frame is None:
                        continue
                else:
                    frame = job
                try:
                    _put(self._decomp_q, frame, "decompress")
                except queue.Full:
                    log.warning("decompress queue full, dropping frame")

    # -- stage 3: decompress + display thread ----------------------------

    def _decompress_thread(self) -> None:
        with stream_context(self.stream):
            while True:
                item = self._decomp_q.get()
                if item is None:
                    return
                frame, t_put = item
                profiler.interval("decompress.queue", t_put, _frame_key(frame))
                try:
                    self._handle_frame(frame)
                except Exception as exc:  # noqa: BLE001 - drop the frame, not the receiver
                    log.warning(f"frame handling failed: {exc}")

    def _upload(self, frame: VideoFrame) -> VideoFrame:
        """An uncompressed frame reassembled on the host, on the receiver's
        device: one copy per tile."""
        tiles = [t if isinstance(t, torch.Tensor)
                 else torch.from_numpy(np.ascontiguousarray(t)).to(self.device)
                 for t in frame.tiles]
        out = VideoFrame(frame.desc, tiles, frame.timestamp)
        out.callbacks.update(frame.callbacks)
        return out

    def _handle_frame(self, frame) -> bool:
        key = _frame_key(frame)
        if frame.callbacks.get("display_owned"):
            # LINE_DECODER fast path: the frame is the display's own buffer;
            # show it as-is (ref: video_decoders.cpp:1828 zero-fills only
            # the buffered path)
            with profiler.zone("rx.display", frame=key):
                self.display.put_frame(frame)
            self.display.recycle(frame)
            self.frames_displayed += 1
            return True
        if not is_codec_opaque(frame.desc.color_spec):
            frame = self._upload(frame)
        if frame.desc.tile_count > 1:
            if self.mode.x * self.mode.y == frame.desc.tile_count:
                frame = vf_merge_tiles(frame, self.mode.x, self.mode.y)
            else:
                # mode unknown: merge as a horizontal strip
                frame = vf_merge_tiles(frame, frame.desc.tile_count, 1)
        # decompress if the codec is opaque (JPEG/DXT...) — unless the
        # display takes it natively
        if (is_codec_opaque(frame.desc.color_spec)
                and frame.desc.color_spec not in self.display.get_property_codecs()):
            if self._decompress is None or frame.desc.color_spec != self._comp_codec:
                self._decompress, self._decomp_out = decompress_init(
                    frame.desc.color_spec, self.display.get_property_codecs(), self.device)
                self._comp_codec = frame.desc.color_spec
                if self._decompress is None:
                    log.error(f"no decompressor for {frame.desc.color_spec.name}")
                    return False
            try:
                with profiler.zone("rx.decompress", frame=key):
                    frame = self._decompress.decompress(frame, self._decomp_out)
            except ValueError as exc:  # corrupt bitstream from an incomplete frame
                # the reference drops frames whose decompression fails rather
                # than tearing the session down (video_decoders.cpp decompress
                # error path); incomplete frames are passed on zero-filled and
                # may be undecodable
                log.warning(f"decompress failed, dropping frame: {exc}")
                return False
            if frame is None:
                return False
        # pixel format conversion to display codec if needed
        codecs = self.display.get_property_codecs()
        if frame.desc.color_spec not in codecs:
            if self._decoder is None or frame.desc.color_spec != self._conv_in:
                self._decoder, self._decoder_out = pixfmt.get_best_decoder_from(
                    frame.desc.color_spec, codecs)
                self._conv_in = frame.desc.color_spec
            if self._decoder is None:
                log.error(f"cannot convert {frame.desc.color_spec.name} for display")
                return False
            data = pixfmt.convert_frame(frame.data, frame.desc.width, frame.desc.color_spec,
                                        self._decoder_out)
            frame = VideoFrame(frame.desc.with_(color_spec=self._decoder_out), [data], frame.timestamp)
        with profiler.zone("rx.postprocess", frame=key):
            out = self.postprocess_chain.apply(frame)
        if out is None:
            return False
        # postprocess may fan one frame out into several (double_framerate)
        for fr in out if isinstance(out, list) else [out]:
            if self._display_desc != fr.desc:
                self.display.reconfigure(fr.desc)
                self._display_desc = fr.desc
            with profiler.zone("rx.display", frame=key):
                self.display.put_frame(fr)
            # presentation done: hand the buffer back to the display pool
            # (ref: vf_recycle + frame pool, video_frame_pool.h:49)
            self.display.recycle(fr)
            self.frames_displayed += 1
        return True

    def _handle_audio(self, node) -> bool:
        frame = self.audio_rx.decode_frame(node)
        if frame is None:
            return False
        if self._audio_desc != frame.desc:
            self.audio_playback.reconfigure(frame.desc)
            self._audio_desc = frame.desc
        if self.control is not None:
            # volume stats for astat clients (ref: astat.cpp stats line)
            self.control.report_stats(format_stats_line("ARECV", frame))
        frame = self._scale_audio(frame)
        if self.echo is not None:  # far-end feed for AEC (ref: echo_play)
            self.echo.play(frame)
        self.audio_playback.put_frame(frame)
        return True

    def _scale_audio(self, frame):
        """--audio-scale factor|auto|none plus runtime volume/mute
        (ref: OPT_AUDIO_SCALE + volume control commands)."""
        vol = 0.0 if self.muted else self.volume
        if self.audio_scale in (None, "", "none") and vol == 1.0:
            return frame
        samples = frame.samples_float()
        if self.audio_scale == "auto":
            peak = float(np.abs(samples).max()) or 1.0
            # follow the running peak toward full scale, limited slew
            self._agc_gain = min(self._agc_gain * 1.02, 0.95 / peak)
            gain = self._agc_gain
        elif self.audio_scale in (None, "", "none"):
            gain = 1.0
        else:
            gain = float(self.audio_scale)
        gain *= vol
        out = AudioFrame.from_float(frame.desc, np.clip(samples * gain, -1.0, 1.0))
        out.timestamp = frame.timestamp
        return out

    def run(self) -> int:
        """Receiver as the reference's 3-stage pipeline: rx loop (packet
        drain + reassembly) -> fec thread -> decompress/display thread with
        bounded queues (ref: video_decoders.cpp:46-93,423,623).

        ``--param vrx-fast=auto`` (the default) drains the socket through
        the C depacketizer (net/vrx_fast.py), which raises if it cannot be
        built; ``off`` takes the Python pbuf path.  Nothing switches between
        them silently."""
        start = time.monotonic()
        idle_since = time.monotonic()
        fast_mode = get_commandline_param("vrx-fast") or "auto"
        if fast_mode not in ("auto", "off"):
            raise ValueError(f"--param vrx-fast={fast_mode}: expected auto or off")
        fast = None
        if fast_mode == "auto":
            fast = FastVideoRx(self.session, self.rx_state,
                               framebuffer_provider=self._framebuffer_provider,
                               stamp_last_arrival=self.stamp_last_arrival)
        else:
            self.session.start_recv_thread()
        self._fast = fast
        self._fec_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._decomp_q: "queue.Queue" = queue.Queue(maxsize=2)
        self.rx_state.framebuffer_provider = self._framebuffer_provider
        fec_t = threading.Thread(target=self._fec_thread, name="fec", daemon=True)
        dec_t = threading.Thread(target=self._decompress_thread, name="decompress", daemon=True)
        fec_t.start()
        dec_t.start()
        with stream_context(self.stream):
            while True:
                if self.should_exit:
                    break
                if self.frame_limit is not None and self.frames_displayed >= self.frame_limit:
                    break
                if self.timeout is not None and time.monotonic() - start > self.timeout:
                    break
                if fast is not None:
                    before = self.session.packets_received
                    pkts = fast.drain(timeout=0.0001)
                    now = time.monotonic()
                    got_any = self.session.packets_received != before
                    for pkt in pkts:  # slow-path packets -> pbuf as usual
                        self.pbuf.insert(pkt)
                    self.pbuf.decode(now, self._reassemble_cb)
                    self.pbuf.remove_old(now)
                    ready = fast.poll(now, self.pbuf.playout_delay)
                    for out in ready:
                        self._hand_off(out)
                    if got_any:
                        idle_since = now
                else:
                    # batch-granularity drain: one queue op per recvmmsg batch
                    pkts = self.session.recv_many(timeout=0.0001, max_pkts=512)
                    now = time.monotonic()
                    for pkt in pkts:
                        self.pbuf.insert(pkt)
                    got_any = bool(pkts)
                    if got_any:
                        idle_since = now
                    self.pbuf.decode(now, self._reassemble_cb)
                    self.pbuf.remove_old(now)
                if self.audio_playback is not None:
                    apkts = self.audio_session.recv_many(timeout=0.0001, max_pkts=64)
                    for apkt in apkts:
                        self.audio_pbuf.insert(apkt)
                    if apkts:
                        got_any, idle_since = True, now
                    self.audio_pbuf.decode(now, self._handle_audio)
                    self.audio_pbuf.remove_old(now)
                if not got_any and now - idle_since > 0.002:
                    time.sleep(0.001)  # avoid busy-spin when idle
        self.session.close()
        if fast is not None:
            fast.close()
        self._fec_q.put(None)  # poison pill cascades through the stages
        fec_t.join(timeout=5)
        dec_t.join(timeout=5)
        if self.audio_playback is not None:
            self.audio_session.close()
            self.audio_playback.done()
        self.display.put_frame(None)
        self.display.done()  # join display worker threads cleanly
        return self.frames_displayed


def run_receiver(args) -> int:
    # live sessions always get a control socket + keyboard, like the
    # reference (ref: control_init + keyboard start, main.cpp:1288-1306)
    root = Module("root")
    control = None
    if args.control_port is not None:
        try:
            control = ControlServer(root, args.control_port)
            log.notice(f"control socket on 127.0.0.1:{control.port}")
        except OSError as e:
            log.warning(f"control socket unavailable: {e}")
    receiver = VideoReceiver(
        display_spec=args.display,
        rx_port=int(str(args.ports).split(":")[0]),
        frame_limit=args.frames,
        postprocess=args.postprocess,
        audio_playback=args.audio_playback,
        mode=args.mode,
        control=control,
        # receiver-mode `uv -d gl 239.x.y.z` joins the multicast group
        mcast_addr=args.host,
        force_ip_version=args.force_ip_version,
        root=root,
        mcast_if=args.mcast_if,
        audio_delay_ms=args.audio_delay or 0,
        audio_scale=args.audio_scale,
        encryption=args.encryption,
        device=args.device,
    )

    def _stop():
        receiver.should_exit = True

    kb = KeyboardControl(root, on_exit=_stop)
    kb.start()  # no-op unless stdin is a tty
    n = receiver.run()
    if control is not None:
        control.close()
    log.notice(f"displayed {n} frames")
    return 0
