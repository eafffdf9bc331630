"""Full-duplex session: send AND receive in one process.

The port of ``ultragrid_tpu/pipeline/duplex.py``.  The reference's normal
videoconferencing invocation ``uv -t <cap> -d <disp> <peer>`` runs the
capture/compress/tx chain and the rx/decode/display chain simultaneously
(ref: capture thread main.cpp:347-397 + receiver thread rxtx.cpp:153 in the
same process, sharing the module tree, control socket and keyboard).  This
module composes the port's VideoSender and VideoReceiver the same way: one
root module, one control socket, receiver on the rx port, sender to
peer:tx_port.  Both halves run on ``args.device`` (the card unless
``--device cpu``), each entering its own pipeline stream; ``-c jpeg`` runs
K1 once a frame on the sender and, with ``-f ldgm`` and ``--param
ldgm-device=device``, the receiver's peel runs K2.  ``--echo-cancellation``
gives both halves one ``EchoCanceller`` (host numpy, as in the reference).
"""

from __future__ import annotations

import threading
import time

from ultragrid_tpu_torch.audio.echo import EchoCanceller
from ultragrid_tpu_torch.net.transmit import parse_bitrate
from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver
from ultragrid_tpu_torch.pipeline.sender import VideoSender
from ultragrid_tpu_torch.utils.log import Logger

log = Logger("duplex")


def run_duplex(args) -> int:
    parts = [p for p in str(args.ports).split(":") if p]
    rx_port = int(parts[0])
    tx_port = int(parts[1]) if len(parts) > 1 else rx_port

    bitrate, bitrate_fixed = parse_bitrate(args.limit_bitrate)
    sender = VideoSender(
        capture_spec=args.capture,
        host=args.host,
        compress_spec=args.compress,
        fec_spec=args.fec,
        tx_port=tx_port,
        mtu=args.mtu,
        frame_limit=args.frames,
        capture_filter=args.capture_filter,
        audio_capture=args.audio_capture,
        audio_codec=args.audio_codec,
        audio_fec=args.audio_fec,
        audio_channel_map=args.audio_channel_map,
        audio_filter=args.audio_filter,
        record=args.record,
        mode=args.mode,
        rtp_standard=args.rtp_standard,
        control_port=args.control_port,
        start_paused=args.start_paused,
        bitrate=bitrate,
        bitrate_fixed=bitrate_fixed,
        ttl=args.ttl if args.ttl >= 0 else 255,
        force_ip_version=args.force_ip_version,
        mcast_if=args.mcast_if,
        audio_host=args.audio_host,
        encryption=args.encryption,
        device=args.device,
    )
    receiver = VideoReceiver(
        display_spec=args.display,
        rx_port=rx_port,
        postprocess=args.postprocess,
        audio_playback=args.audio_playback,
        mode=args.mode,
        control=sender.control,  # ONE control socket for the whole session
        mcast_addr=args.host,  # joins the group iff the peer addr is mcast
        force_ip_version=args.force_ip_version,
        root=sender.root,  # shared module tree: runtime msgs reach both
        mcast_if=args.mcast_if,
        audio_delay_ms=args.audio_delay or 0,
        audio_scale=args.audio_scale,
        encryption=args.encryption,
        device=args.device,
    )

    if args.echo_cancellation and sender.audio is not None and receiver.audio_playback is not None:
        # AEC: receiver playback = far end, sender capture = near end
        # (ref: echo_play/echo_cancel, src/audio/echo.cpp)
        ec = EchoCanceller()
        sender.echo = ec
        receiver.echo = ec
        log.notice("echo cancellation active")

    rx_thread = threading.Thread(target=receiver.run, name="rx-pipeline", daemon=True)
    rx_thread.start()
    try:
        n = sender.run()
        log.notice(f"sent {n} frames")
        # drain window: let in-flight packets clear the playout buffer before
        # stopping the receive chain (ref: pbuf playout delay, pbuf.c:191)
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline and receiver.frames_displayed < (n or 0):
            time.sleep(0.05)
    finally:
        receiver.should_exit = True
        rx_thread.join(timeout=10)
    log.notice(f"displayed {receiver.frames_displayed} frames")
    return 0
