"""CLI entry point of the port, the analogue of the reference's ``uv`` binary.

The port of ``ultragrid_tpu/cli.py``: the same option grammar
(src/main.cpp:690-740):

  -t DEVICE[:cfg]    capture device (testcard, testcard2, noise, file, screen, rtsp, ...)
  -d DISPLAY[:cfg]   display (dummy, null, dump, file, conference, x11, gl, drm, ...)
  -c COMPRESS[:opts] video compression (none, uyvy, dxt, jpeg[:rate=], h264[:opts], libavcodec, ...)
  -f FEC             forward error correction ([A:|V:]none|mult:N|ldgm:...|rs:k:n)
  -s / -r / -A       audio capture, playback and codec (PCM, alaw, ulaw, Opus, G722, ...)
  -E DIR / -I DIR    record the session / replay a recording as the capture
  -x PROTOCOL        ultragrid_rtp (default), loopback, mpegts or ihdtv
  -N [MODE]          map the RTP ports at the NAT (auto|pcp|natpmp|upnp) or
                     holepunch:room=R:server=H through a nat-helper room
  --rtp-standard     send JPEG as RFC 2435 on PT 26 and serve its SDP over HTTP
  --rtsp             serve the session over RTSP (implies --rtp-standard)
  --window-title T   the title of a windowed display's window
  --device DEV       where frames live and kernels run: cuda (default) or cpu
  --cuda-device I,J  the cards a JPEG session splits each frame over, by row band (help lists them)

Run a sender ``python -m ultragrid_tpu_torch -t testcard -c jpeg -f ldgm
<host>``, a receiver ``python -m ultragrid_tpu_torch -d dummy``, both on the
card unless ``--device cpu`` is given; ``-t ... -d ... <peer>`` is a
full-duplex call (``pipeline/duplex.py``, with ``--echo-cancellation``).
``-e`` needs the Python package ``cryptography``; the libavcodec modules
(``-c libavcodec``, ``-A Opus`` and the other lavc audio codecs, ``-x
mpegts``, ``--param h264-decoder=lavc``) need FFmpeg's headers and refuse
with an error that names libavcodec without them.  ``-t`` and ``-d`` names
are resolved through the aliases of ``~/.ug.rc`` (``utils/config_file.py``).
``-x sage`` and ``-x omt`` need SDKs that are absent, and are refused as in
the reference.
"""

from __future__ import annotations

import argparse
import sys

from ultragrid_tpu_torch.modules.registry import LibraryClass, list_modules
from ultragrid_tpu_torch.utils import log as _log
from ultragrid_tpu_torch.utils.params import print_param_doc, set_commandline_param

# protocols whose SDKs are absent (ref: src/rxtx/sage.cpp, omt.cpp)
_SDK_PROTOCOLS = {"sage": "SAGE", "omt": "Open Media Transport"}


def cuda_device_help() -> str:
    """``--cuda-device help``: the CUDA cards, index and name, as the
    reference lists them for the same option."""
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lines = ["CUDA devices:"] + [f"\t{i} - {torch.cuda.get_device_name(i)}" for i in range(n)]
    if not n:
        lines.append("\t(none)")
    return "\n".join(lines + ["--cuda-device <i,j,...> splits a JPEG session's frames over those cards, "
                               "one row band a card"])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ultragrid-tpu-torch",
        description="UltraGrid-class media pipeline, PyTorch + CUDA port")
    p.add_argument("-t", "--capture", default=None, help="capture device spec")
    p.add_argument("-d", "--display", default=None, help="display spec")
    p.add_argument("-c", "--compress", default="none",
                   help="video compression: none|uyvy|dxt|jpeg[:q][:ri][:sub][:rate=<bps>]|"
                        "h264[:qp=N][:mode=i16|i4|pcm|inter][:gop=N][:search=N][:accel=host|device]"
                        "[:entropy=cavlc|cabac][:subpel=half|quarter][:rate=<bps>] (h264:help lists them)|"
                        "jpegxs[:quality]|cineform[:quality]|openapv|apv[:qp=N][:tile_w=N][:tile_h=N]|"
                        "j2k|cmpto_j2k[:quality]")
    p.add_argument("-f", "--fec", action="append", default=None,
                   help="FEC: [A:|V:]{none|mult:N|ldgm:k:m:c|ldgm:P%%|rs:k:n} "
                        "(A:/V: select the medium; ref: main.cpp:824-839)")
    p.add_argument("-e", "--encryption", default=None,
                   help="AES passphrase[:cipher=gcm|cbc|ctr|cfb] (needs the package cryptography)")
    p.add_argument("-l", "--limit-bitrate", default="auto",
                   help="auto|dynamic|unlimited|<num>[kMG][!][E] "
                        "(ref: parse_bitrate, rtp_common.c:777)")
    p.add_argument("-T", "--ttl", type=int, default=-1,
                   help="TTL for multicast/unicast (0..255, -1 default)")
    p.add_argument("-4", dest="force_ip_version", action="store_const", const=4,
                   default=0, help="force IPv4 resolution")
    p.add_argument("-6", dest="force_ip_version", action="store_const", const=6,
                   help="force IPv6 resolution")
    p.add_argument("--start-paused", action="store_true",
                   help="start the sender paused; unpause with the control socket's 'play'")
    p.add_argument("--conv-policy", default=None, metavar="dsc",
                   help="pixfmt conversion preference order: permutation of "
                        "d(epth) s(ubsampling) c(olor) (ref: host.cpp:344)")
    p.add_argument("--pix-fmts", action="store_true",
                   help="list supported pixel formats (ref: OPT_PIX_FMTS)")
    p.add_argument("--video-codecs", action="store_true",
                   help="list video codecs (ref: OPT_VIDEO_CODECS)")
    p.add_argument("-v", "--version", action="store_true", help="print version and exit")
    p.add_argument("-H", "--fullhelp", action="store_true",
                   help="extended module listing (alias of --list-modules)")
    p.add_argument("--mcast-if", default=None, metavar="IFADDR",
                   help="IPv4 address of the interface for multicast "
                        "(ref: --mcast-if, main.cpp:892)")
    p.add_argument("-P", "--ports", default="5004", help="RTP base port[:tx]")
    p.add_argument("-m", "--mtu", type=int, default=1500)
    p.add_argument("-M", "--mode", default="normal",
                   help="video mode: normal|dual-link|3D|tiled-2x2|3x1")
    p.add_argument("-V", "--verbose", action="count", default=0)
    p.add_argument("--param", action="append", default=[], help="key=value tuning params")
    p.add_argument("-n", "--control-port", type=int, default=5054,
                   help="runtime control TCP port (0 = ephemeral; "
                        "ref: control_socket.c:178, default 5054)")
    p.add_argument("-F", "--capture-filter", default="", help="comma-separated capture filter chain")
    p.add_argument("-p", "--postprocess", default="", help="display postprocess chain")
    p.add_argument("--frames", type=int, default=None, help="stop after N frames")
    p.add_argument("-x", "--protocol", default="ultragrid_rtp",
                   help="rxtx protocol: ultragrid_rtp | loopback | mpegts | ihdtv (sage/omt need their "
                        "SDKs, absent here; ref: --protocol)")
    p.add_argument("-L", "--list-modules", action="store_true")
    p.add_argument("-b", "--capabilities", action="store_true",
                   help="print machine-readable capabilities JSON (GUI contract)")
    p.add_argument("--device", default="cuda",
                   help="torch device of frames and kernels: cuda (default) or cpu")
    p.add_argument("--cuda-device", default=None, metavar="<i,j,...>|help",
                   help="the CUDA cards a JPEG session splits each frame over, one row band a card "
                        "(--param cuda-device); help lists the cards (ref: --cuda-device, host.h:98-100)")
    p.add_argument("-I", "--playback", default=None, metavar="DIR",
                   help="replay a recorded session directory as the capture "
                        "(ref: -I/--playback, main.cpp:904-915)")
    p.add_argument("-E", "--record", nargs="?", const="", default=None,
                   help="export the session to DIR (default auto-named)")
    p.add_argument("-U", "--audio-channel-map", default=None,
                   help="src:dst[,src:dst...] audio channel remap")
    p.add_argument("--audio-delay", type=int, default=0,
                   help="ms to delay audio against video (negative delays "
                        "video; ref: set_audio_delay, host.cpp:1019)")
    p.add_argument("-a", "--audio-capture-format", default=None,
                   help="{channels=<num>|bps=<bits>|sample_rate=<rate>}"
                        "[:...] capture format overrides (ref: -a, "
                        "parse_audio_format audio/utils.cpp:720)")
    p.add_argument("--audio-capture-channels", type=int, default=None,
                   help="shorthand for -a channels=N (ref: main.cpp:725)")
    p.add_argument("--audio-scale", default="none",
                   help="<factor>|auto|none — received-audio scaling "
                        "(ref: OPT_AUDIO_SCALE, main.cpp:858)")
    p.add_argument("--audio-host", default=None,
                   help="send audio to a different address than video "
                        "(ref: OPT_AUDIO_HOST, main.cpp:895)")
    p.add_argument("-s", "--audio-capture", default=None,
                   help="audio capture (testcard, wav:FILE, none, embedded, ...)")
    p.add_argument("-r", "--audio-playback", default=None, help="audio playback (dummy, wav:FILE)")
    p.add_argument("-A", "--audio-codec", default="PCM",
                   help="audio codec: PCM|alaw|ulaw|Opus|G722|speex|MP3|AAC|FLAC (the last six need libavcodec)")
    p.add_argument("-i", "--audio-filter", default=None,
                   help="<filter>[:<config>][#<filter>...] — gain/delay/"
                        "silence/discard/channel_remap/controlport_stats "
                        "(ref: main.cpp:271)")
    p.add_argument("--echo-cancellation", action="store_true",
                   help="cancel playback echo from captured audio in duplex "
                        "sessions (ref: --echo-cancellation, audio/echo.cpp)")
    p.add_argument("--rtsp", action="store_true",
                   help="serve the session over RTSP (implies --rtp-standard for JPEG)")
    p.add_argument("--rtp-standard", action="store_true",
                   help="send JPEG as standards-compliant RFC 2435 / PT 26 (interop mode)")
    p.add_argument("--window-title", default=None,
                   help="window title for windowed displays (ref: OPT_WINDOW_TITLE)")
    p.add_argument("-N", "--nat-traverse", nargs="?", const="auto", default=None, metavar="MODE",
                   help="map RTP ports at the NAT: auto|pcp|natpmp|upnp, or "
                        "holepunch:room=R:server=H[:port] (ref: -N/--nat-traverse, utils/nat.c)")
    p.add_argument("--audio-protocol", default=None, help=argparse.SUPPRESS)
    p.add_argument("--video-protocol", default=None, help=argparse.SUPPRESS)
    p.add_argument("host", nargs="?", default=None, help="receiver address (sender mode)")
    return p


def refusal(args) -> str:
    """Why the port cannot run ``args``, or "" when it can."""
    if args.audio_protocol or args.video_protocol:
        # the reference removed per-medium protocols too (main.cpp:630-636)
        return "Separate audio and video protocol setting no longer available!"
    if args.protocol in _SDK_PROTOCOLS:
        # the reference gates these modules behind their SDKs (ref:
        # src/rxtx/sage.cpp, omt.cpp); neither SDK exists here
        return (f"{args.protocol}: requires the {_SDK_PROTOCOLS[args.protocol]} SDK, "
                "which is not present on this system")
    if args.protocol not in ("ultragrid_rtp", "loopback", "mpegts", "ihdtv"):
        return f"unknown protocol {args.protocol!r}"
    return ""


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _log.set_log_level(_log.LOG_LEVEL_INFO + args.verbose)

    # backtrace-on-crash like the reference (host.cpp crash_signal_handler)
    from ultragrid_tpu_torch.utils.crash import install_crash_handler

    install_crash_handler()

    if args.version:
        from ultragrid_tpu_torch import __version__

        print(f"ultragrid-tpu-torch {__version__} (PyTorch + CUDA)")
        return 0

    why = refusal(args)
    if why:
        print(why, file=sys.stderr)
        return 1

    if args.pix_fmts or args.video_codecs:
        from ultragrid_tpu_torch.types import VCF_INTERFRAME, Codec, get_codec_info

        for c in Codec:
            info = get_codec_info(c)
            if c == Codec.NONE:
                continue
            is_pixfmt = not info.opaque
            if (args.pix_fmts and is_pixfmt) or (args.video_codecs and not is_pixfmt):
                attrs = []
                if is_pixfmt:
                    attrs.append(f"{info.bits_per_channel}b")
                    attrs.append("rgb" if info.rgb else "yuv")
                if info.flags & VCF_INTERFRAME:
                    attrs.append("interframe")
                print(f"{c.name:12s} {' '.join(attrs)}")
        return 0

    if args.audio_capture_format:
        from ultragrid_tpu_torch.audio.capture import set_audio_capture_format

        try:
            set_audio_capture_format(args.audio_capture_format)
        except ValueError as e:
            print(f"-a: {e}", file=sys.stderr)
            return 1
    if args.audio_capture_channels:
        from ultragrid_tpu_torch.audio.capture import set_audio_capture_format

        set_audio_capture_format(f"channels={args.audio_capture_channels}")

    if args.conv_policy:
        from ultragrid_tpu_torch.ops.pixfmt import set_pixfmt_conv_policy

        try:
            set_pixfmt_conv_policy(args.conv_policy)
        except ValueError as e:
            print(f"--conv-policy: {e}", file=sys.stderr)
            return 1

    if args.window_title:
        set_commandline_param("window-title", args.window_title)

    if args.cuda_device is not None:
        if args.cuda_device == "help":
            print(cuda_device_help())
            return 0
        from ultragrid_tpu_torch.parallel.mesh import cuda_device_list

        try:
            cuda_device_list(args.cuda_device)
        except ValueError as e:
            print(e, file=sys.stderr)
            return 1
        set_commandline_param("cuda-device", args.cuda_device)

    if args.capabilities:
        from ultragrid_tpu_torch.utils.capabilities import print_capabilities

        print_capabilities()
        return 0

    if args.list_modules or args.fullhelp:
        # importing the modules and pipelines registers them and their --param docs
        import ultragrid_tpu_torch.modules  # noqa: F401
        import ultragrid_tpu_torch.pipeline.receiver  # noqa: F401
        import ultragrid_tpu_torch.pipeline.sender  # noqa: F401

        for cls in LibraryClass:
            mods = list_modules(cls)
            if mods:
                print(f"{cls.value}: {' '.join(mods)}")
        print()
        print(print_param_doc())
        return 0

    # -f [A:|V:]spec may appear once per medium (ref: main.cpp:824-839);
    # normalize into args.fec (video) + args.audio_fec
    video_fec, audio_fec = "none", "none"
    for spec in args.fec or []:
        if len(spec) > 2 and spec[1] == ":" and spec[0].upper() in "AV":
            if spec[0].upper() == "A":
                audio_fec = spec[2:]
            else:
                video_fec = spec[2:]
        else:
            video_fec = spec
    args.fec = video_fec
    args.audio_fec = audio_fec

    if args.playback:
        # -I DIR == import capture with embedded audio (ref: playback.c)
        args.capture = f"import:{args.playback}"
        if not args.audio_capture:
            args.audio_capture = "embedded"

    for kv in args.param:
        key, _, val = kv.partition("=")
        set_commandline_param(key, val or None)

    # --param profile[=path] turns on zone tracing (Chrome trace JSON)
    from ultragrid_tpu_torch.utils import profiler

    profiler.maybe_enable_from_params()

    # ~/.ug.rc device aliases (ref: src/utils/config_file.cpp + the alias
    # substitution in video_capture_params.c)
    from ultragrid_tpu_torch.utils.config_file import ConfigFile

    cf = ConfigFile()
    if args.capture:
        args.capture, alias_filter = cf.resolve_device("capture", args.capture)
        if alias_filter:
            args.capture_filter = f"{args.capture_filter},{alias_filter}" if args.capture_filter else alias_filter
    if args.display:
        args.display, _ = cf.resolve_device("display", args.display)

    if args.nat_traverse and args.nat_traverse.startswith("holepunch"):
        # pair through a nat-helper room and punch, then run the normal
        # session toward the punched peer (ref: udp_holepunch.cpp +
        # adjust_params_holepunch, main.cpp:1033-1075)
        from ultragrid_tpu_torch.net.nat import holepunch_establish, parse_holepunch_conf

        try:
            conf = parse_holepunch_conf(args.nat_traverse)
            rx = int(str(args.ports).split(":")[0])
            peer_host, peer_port = holepunch_establish(conf, rx)
        except (ValueError, OSError, ConnectionError) as e:
            print(f"holepunch failed: {e}", file=sys.stderr)
            return 1
        args.host = peer_host
        args.ports = f"{rx}:{peer_port}"
        # a receive-only invocation still needs a sender for the punched
        # path to stay open (ref: adjust_params_holepunch testcard:2:2)
        if not args.capture and args.display:
            args.capture = "testcard:s=2x2:f=1"
        print(f"holepunch: session to {peer_host}:{peer_port}", file=sys.stderr)
    elif args.nat_traverse:
        # map the RTP rx ports at the NAT before any socket binds
        # (ref: start_nat_traverse, main.cpp:1300; utils/nat.c order)
        from ultragrid_tpu_torch.net.nat import setup_nat_traverse

        rx = int(str(args.ports).split(":")[0])
        audio_rx = rx + 2 if (args.audio_playback or args.audio_capture) else 0
        res = setup_nat_traverse(rx, audio_rx, mode=args.nat_traverse)
        if not res["mode"]:
            # the reference aborts on a failed -N mapping (main.cpp
            # start_nat_traverse failure -> exit_uv) so scripts can detect it
            print("NAT traversal failed (no PCP/NAT-PMP/UPnP gateway reachable)", file=sys.stderr)
            return 1
        print(f"NAT: mapped via {res['mode']}: {res['mappings']}", file=sys.stderr)

    if args.protocol == "mpegts":
        # H.264-in-TS over UDP (ref: src/rxtx/mpegts.c); playable by any TS
        # receiver (VLC/ffplay)
        from ultragrid_tpu_torch.pipeline.mpegts import MpegTsReceiver, MpegTsSender

        port = int(str(args.ports).split(":")[0])
        try:
            if args.capture and args.host:
                s = MpegTsSender(args.capture, args.host, port, frame_limit=args.frames,
                                 capture_filter=args.capture_filter, device=args.device)
                print(f"sent {s.run()} frames (mpegts)")
                return 0
            if args.display:
                r = MpegTsReceiver(args.display, port, frame_limit=args.frames, device=args.device)
                print(f"displayed {r.run()} frames (mpegts)")
                return 0
        except ValueError as e:
            print(f"mpegts: {e}", file=sys.stderr)
            return 1
    if args.protocol == "ihdtv":
        # legacy dual-stream raw v210 transport (ref: src/rxtx/ihdtv.cpp)
        from ultragrid_tpu_torch.pipeline.ihdtv import run_ihdtv_receiver, run_ihdtv_sender

        if args.capture and args.host:
            return run_ihdtv_sender(args.capture, args.host, mtu=args.mtu,
                                    frame_limit=args.frames, device=args.device)
        if args.display:
            return run_ihdtv_receiver(args.display, frame_limit=args.frames,
                                      mtu=args.mtu, device=args.device)
    if args.protocol == "loopback" and args.capture:
        # single-process fixture: compressed frames straight to the display
        # (ref: src/rxtx/loopback.c)
        from ultragrid_tpu_torch.pipeline.loopback import LoopbackRxTx

        lb = LoopbackRxTx(
            args.capture, args.display or "dummy", compress_spec=args.compress,
            frame_limit=args.frames, capture_filter=args.capture_filter,
            postprocess=args.postprocess, device=args.device,
        )
        n = lb.run()
        print(f"{n} frames processed (loopback)")
        return 0
    if args.capture and args.host and args.display and args.protocol == "ultragrid_rtp" and not args.rtsp:
        # full-duplex videoconferencing mode: -t ... -d ... <peer> sends AND
        # receives in one process (ref: capture thread + receiver thread,
        # main.cpp:347-397 / rxtx.cpp:153)
        from ultragrid_tpu_torch.pipeline.duplex import run_duplex

        return run_duplex(args)
    if args.capture and (args.host or args.rtsp):
        # --rtsp without a host: serve and wait for clients to PLAY
        if args.rtsp:
            args.rtp_standard = True
        from ultragrid_tpu_torch.pipeline.sender import run_sender

        return run_sender(args)
    if args.display and not args.capture:
        from ultragrid_tpu_torch.pipeline.receiver import run_receiver

        return run_receiver(args)
    if args.capture and args.display:
        from ultragrid_tpu_torch.pipeline.loop import run_local_pipeline

        n = run_local_pipeline(args.capture, args.display, args.frames,
                               capture_filter=args.capture_filter,
                               postprocess=args.postprocess, device=args.device)
        print(f"{n} frames processed")
        return 0

    print("nothing to do: specify -t (capture) and/or -d (display)", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
