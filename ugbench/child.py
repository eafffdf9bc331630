"""The session's second process: the port's receiver.

Started by :mod:`ugbench.session` through ``multiprocessing`` (spawn) with
one end of a pipe.  It binds its UDP ports, sends ``("ready", port)``, and
then takes ``("keep", key)`` (keep the displayed picture of the frame whose
RTP timestamp is ``key``), ``("zones",)`` (record the program's spans),
``("trace", a, b)`` (trace the device from monotonic ns ``a`` to ``b``),
``("expect", keys)`` (stop once these frames are all shown) and
``("stop",)``, and answers the stop with ``("result", dict)``.  Where it
cannot give the run what the configuration states, it sends
``("refused", reason)`` in place of ``("ready", port)`` and ends.
"""

from __future__ import annotations

import socket
import sys
import threading
import time

# JAX and the JAX package: no process of a run may load them (top-level
# names compared whole; the port's name begins with the JAX package's)
FORBIDDEN = {"jax", "jaxlib", "flax", "ultragrid_tpu"}


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``)."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)} & FORBIDDEN)


def free_port_pair() -> int:
    """A UDP port p with p + 1 free too (RTP and RTCP)."""
    for _ in range(64):
        a = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        b = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            a.bind(("", 0))
            port = a.getsockname()[1]
            b.bind(("", port + 1))
        except OSError:
            continue
        finally:
            a.close()
            b.close()
        return port
    raise RuntimeError("no free UDP port pair")


def rtp_key(timestamp: float) -> int:
    """The 90 kHz RTP timestamp a frame stamped at ``timestamp`` seconds
    carries (``net/transmit.py`` truncates)."""
    return int(timestamp * 90000) & 0xFFFFFFFF


def received_key(timestamp: float) -> int:
    """The RTP timestamp back from a received frame's ``timestamp`` (the
    receiver divides it by 90,000)."""
    return int(round(timestamp * 90000)) & 0xFFFFFFFF


def udp_rcvbuf_errors() -> int:
    """The host's count of UDP datagrams dropped for a full receive buffer
    (``RcvbufErrors`` in /proc/net/snmp), or -1 where it cannot be read."""
    try:
        with open("/proc/net/snmp") as fh:
            rows = [ln.split() for ln in fh if ln.startswith("Udp:")]
        return int(rows[1][rows[0].index("RcvbufErrors")])
    except (OSError, IndexError, ValueError):
        return -1


def force_rcvbuf(sock, nbytes: int) -> int:
    """Give the receiver's socket the buffer the configuration states, past
    the host's ``net.core.rmem_max`` (as a deployment's raised limit does;
    SO_RCVBUFFORCE needs CAP_NET_ADMIN), where the host's limit does not
    already allow it.  Returns the buffer the socket was given (Linux
    reports twice that, for its bookkeeping)."""
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, nbytes)
    if sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF) // 2 < nbytes:
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUFFORCE, nbytes)
        except (OSError, AttributeError):
            pass  # the caller refuses the run
    return sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF) // 2


def warm_receive_path(cfg: dict, dev) -> None:
    """Decode one file of the cell's geometry and peel one lost symbol on
    the device before any traffic: the first decode loads the libraries,
    the device's modules and cuBLAS, which would otherwise stall the
    session's first frames for seconds while the socket overflows."""
    import numpy as np
    import torch

    from ugbench import content
    from ultragrid_tpu_torch.modules.video_compress import compress_init
    from ultragrid_tpu_torch.modules.video_decompress import decompress_init
    from ultragrid_tpu_torch.ops.fec import fec_from_spec
    from ultragrid_tpu_torch.types import Codec, InterlacingType, VideoDesc, VideoFrame

    frame = content.ring(1, cfg["width"], cfg["height"], n=1, device=dev)[0]
    desc = VideoDesc(cfg["width"], cfg["height"], Codec.UYVY, 30.0, InterlacingType.PROGRESSIVE, 1)
    jpeg = compress_init(cfg["compress"], dev).compress(VideoFrame(desc, [frame]))
    dec, out_codec = decompress_init(Codec.JPEG, [Codec[cfg["display_codec"]]], dev)
    dec.decompress(jpeg, out_codec)
    fec = fec_from_spec(cfg["fec"])
    buf, fd = fec.encode(np.asarray(jpeg.data))
    sym = buf.reshape(fd.k + fd.m, -1)
    present = np.ones(fd.k + fd.m, bool)
    present[0] = False
    fec.decode_device(sym, present, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def receiver_main(conn, cfg: dict, device_name: str, trace_on: bool = False, setup: str = None) -> None:
    stages = {"start": time.monotonic_ns()}
    rcvbuf_errors = udp_rcvbuf_errors()
    import torch

    from ugbench import trace
    from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
    from ultragrid_tpu_torch.modules.video_display import VideoDisplay
    from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver
    from ultragrid_tpu_torch.types import Codec
    from ultragrid_tpu_torch.utils import params

    stages["imports"] = time.monotonic_ns()
    dev = torch.device(device_name)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)  # the card's start-up, before any socket
    stages["device"] = time.monotonic_ns()
    for k, v in cfg.get("params", {}).items():
        params.set_commandline_param(k, v)
    keep, shown, pictures = set(), [], {}
    pending = {"keys": None}
    lock = threading.Lock()
    stopped = {}

    def stop():
        with lock:
            if "t" not in stopped:
                stopped["t"] = time.monotonic_ns()
                recv.should_exit = True

    class BenchDisplay(VideoDisplay):
        """Stamps each frame's display instant once its data is complete
        on the device (the stream it was made on is synchronised)."""

        def get_property_codecs(self):
            return [Codec[cfg["display_codec"]]]

        def put_frame(self, frame, blocking: bool = True) -> None:
            if frame is None:
                return
            data = frame.data
            if isinstance(data, torch.Tensor) and data.is_cuda:
                torch.cuda.current_stream(data.device).synchronize()
            now = time.monotonic_ns()
            key = received_key(frame.timestamp)
            shown.append((key, now))
            if key in keep:
                pictures[key] = data.clone() if isinstance(data, torch.Tensor) else data.copy()
            super().put_frame(frame, blocking)
            with lock:
                left = pending["keys"]
                if left is not None:
                    left.discard(key)
            if left is not None and not left:
                stop()

    register_module("ugbench", LibraryClass.VIDEO_DISPLAY, BenchDisplay)
    if setup:
        import importlib

        mod, _, fn = setup.partition(":")
        getattr(importlib.import_module(mod), fn)()
    recv = None
    for _ in range(8):
        port = free_port_pair()
        try:
            recv = VideoReceiver("ugbench", rx_port=port, playout_delay=cfg["playout_ms"] / 1000.0,
                                 device=dev)
            break
        except OSError:
            continue
    if recv is None:
        raise RuntimeError("could not bind the receiver's ports")
    rcvbuf = force_rcvbuf(recv.session.sock, cfg["udp_rcvbuf_bytes"])
    if rcvbuf < cfg["udp_rcvbuf_bytes"]:
        recv.session.sock.close()
        conn.send(("refused", f"the receiver's socket was given {rcvbuf} B, less than the configuration's "
                              f"udp_rcvbuf_bytes {cfg['udp_rcvbuf_bytes']} (SO_RCVBUFFORCE needs CAP_NET_ADMIN)"))
        conn.close()
        return
    stages["receiver_built"] = time.monotonic_ns()
    warm_receive_path(cfg, dev)
    stages["warm"] = time.monotonic_ns()

    # the peel's launches: symbol size and rounds of each FEC job with loss
    peels = []
    rx_state = recv.rx_state
    decode_job = rx_state.decode_fec_job

    def traced_decode(job):
        got = job.got
        lost = not bool(got.all())
        out = decode_job(job)
        if lost:
            frame_len, k, m, c, seed = job.params
            sess = rx_state._get_fec(job.kind, k, m, c, seed)
            peels.append((time.monotonic_ns(), frame_len // (k + m), k, m, int(sess.matrix.sum()),
                          int(getattr(sess, "rounds", 0))))
        return out

    rx_state.decode_fec_job = traced_decode
    tracer = trace.DeviceTracer()
    tracing = threading.Event()

    if trace_on and dev.type == "cuda":
        tracer.start()  # the profiler's first start takes seconds: before any traffic
        tracer.stop()
    # the receiver runs on a thread of its own, the device trace on another;
    # this one takes the messages
    gc_pauses = trace.GcPauses()
    gc_pauses.start()
    rt = threading.Thread(target=recv.run, name="ugbench-receiver", daemon=True)
    rt.start()
    conn.send(("ready", port))
    traced = {}

    finished = threading.Event()

    def trace_slice(a, b):
        """The device trace from monotonic ns ``a`` until the receiver has
        finished (its slice ends at ``b``), on this thread: the profiler is
        bound to the thread that starts it, and its stop holds the
        interpreter lock for up to a second, which would stall the session
        before it has shown every frame."""
        time.sleep(max(0, a - time.monotonic_ns()) / 1e9)
        t = time.monotonic_ns()
        tracer.start()
        t_a = time.monotonic_ns()
        traced["start_s"] = (t_a - t) / 1e9
        finished.wait()
        traced["kernels"] = tracer.stop()
        traced["slice"] = (t_a, b)

    tt = None
    while "t" not in stopped:
        if not conn.poll(0.05):
            continue
        msg = conn.recv()
        if msg[0] == "keep":  # sent as the window opens
            keep.update(msg[1])
            stages["rcvbuf_errors_at_window"] = udp_rcvbuf_errors() - rcvbuf_errors
        elif msg[0] == "zones":
            trace.zones_start()
            tracing.set()
        elif msg[0] == "trace":
            if dev.type == "cuda":
                tt = threading.Thread(target=trace_slice, args=msg[1:], name="ugbench-trace", daemon=True)
                tt.start()
        elif msg[0] == "expect":
            with lock:
                pending["keys"] = set(msg[1]) - {k for k, _ in shown}
                left = pending["keys"]
            if not left:
                stop()
        elif msg[0] == "stop":
            stop()
    rt.join(timeout=30)
    gc_pauses.stop()
    finished.set()
    if tt is not None:
        tt.join(timeout=60)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    result = {
        "shown": shown,
        "pictures": {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v) for k, v in pictures.items()},
        "memory_peak_bytes": int(mem),
        "fec_jobs": rx_state.fec_jobs,
        "fec_recovered": rx_state.fec_recovered,
        "frames_missing_data": rx_state.frames_missing_data,
        "peels": peels,
        "t_stop_ns": stopped.get("t", time.monotonic_ns()),
        "kernels": traced.get("kernels", []),
        "trace_slice": traced.get("slice"),
        "trace_start_s": traced.get("start_s"),
        "stages": {k: v for k, v in stages.items() if k != "rcvbuf_errors_at_window"},
        "rcvbuf_errors_at_window": stages.get("rcvbuf_errors_at_window"),
        "rcvbuf_errors": udp_rcvbuf_errors() - rcvbuf_errors,
        "rcvbuf_bytes": rcvbuf,
        "zones": trace.zones_take() if tracing.is_set() else [],
        "gc_pauses": gc_pauses.events,
        # what this process loaded, once the window has closed
        "forbidden": forbidden_loaded(),
    }
    conn.send(("result", result))
    conn.close()

