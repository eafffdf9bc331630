"""End-to-end frame latency benchmark: capture -> display, live session.

The port of ``ultragrid_tpu/tools/bench_latency.py``.  Measures the
p50/p95/p99 of (capture instant -> display put) per frame across a REAL
localhost session: testcard capture thread -> compress -> FEC -> RTP/UDP ->
recv thread -> pbuf (32 ms playout budget, ref: src/rtp/pbuf.c:191) -> FEC
decode -> decompress -> display.  The capture instant rides the RTP
timestamp (90 kHz, stamped at grab -- ref: the role of tv_to_rtp in
src/transmit.c), so on a same-clock localhost pair the receiver can
difference it against time.monotonic() directly (CLOCK_MONOTONIC shares its
epoch across processes on Linux).

Sender and receiver run in SEPARATE processes like a real deployment -- in
one process they would share the interpreter lock and measure contention,
not the pipeline.  Both run on the same device (the card unless ``--device
cpu``); the receiver child is ``python -m
ultragrid_tpu_torch.tools.bench_latency --recv-child ...`` and gets the
parent's device.  The child brings the card up (CUDA's start-up takes most
of a second in a fresh process) and warms its decode path before it binds
its socket and prints READY; otherwise the sender would fill the socket
buffers meanwhile.  The warm-up builds and first launches the kernels: the
port has no JIT graphs to compile.

This is BASELINE.md's second metric ("p50 per-frame pipeline latency") and
the analogue of the reference's ~100 ms camera->display claim.

Usage: python -m ultragrid_tpu_torch.tools.bench_latency [WxH] [fps] [frames]
           [compress] [fec] [--json] [--device cpu] [--port N]
e.g.   python -m ultragrid_tpu_torch.tools.bench_latency 1920x1080 60 300 jpeg \\
           ldgm:256:26:5 --json
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ultragrid_tpu_torch.tools._bench import device_arg, sync

TS_MOD = float(0x100000000) / 90000.0  # RTP TS wrap period in seconds
DEFAULT_PORT = 25910
# the repository root: the child runs ``-m ultragrid_tpu_torch...`` from it
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def port_arg(argv, default: int):
    """(argv without ``--port N``, N or the default)."""
    rest = list(argv)
    if "--port" in rest:
        i = rest.index("--port")
        port = int(rest[i + 1])
        del rest[i:i + 2]
        return rest, port
    return rest, default


def is_jpeg(compress: str) -> bool:
    return compress.split(":")[0].lower() in ("jpeg", "gpujpeg")


def warm_graphs(w: int, h: int, compress: str, device: torch.device, decode_side: bool = False) -> None:
    """Build and first-launch the encode (and decode) path, so the live
    session measures steady state."""
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder, decode_jpeg_to_frame
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
    from ultragrid_tpu_torch.utils.pattern import generate_pattern

    q = 80
    for tok in compress.split(":")[1:]:
        if tok.isdigit():
            q = int(tok)
    enc = JpegEncoder(w, h, in_codec=Codec.UYVY, quality=q)
    data = enc.encode(generate_pattern(w, h, Codec.UYVY, "bars", device=device))
    if decode_side:
        jf = VideoFrame(VideoDesc(w, h, Codec.JPEG, 60.0), [data])
        decode_jpeg_to_frame(jf, Codec.UYVY, device=device)
    sync(device)


def _recv_child(frames: int, playout: float, port: int, warm: str, device: torch.device) -> None:
    """Child process: receive ``frames`` frames on ``port``, print per-frame
    (capture -> display) latencies and display times as one JSON line."""
    torch.zeros(1, device=device)  # the card's start-up, before any socket
    if warm:
        w, h = (int(x) for x in warm.split(":")[0].split("x"))
        warm_graphs(w, h, warm.split(":", 1)[1], device, decode_side=True)
    from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver

    latencies: list = []
    display_times: list = []
    recv = VideoReceiver("dummy", rx_port=port, frame_limit=frames, timeout=120.0,
                         playout_delay=playout, device=device)
    orig_handle = recv._handle_frame

    def timed_handle(frame):
        ts = getattr(frame, "timestamp", -1.0)
        ok = orig_handle(frame)
        if ok and ts is not None and ts >= 0:
            now = time.monotonic()
            latencies.append((now - ts) % TS_MOD)
            display_times.append(now)
        return ok

    recv._handle_frame = timed_handle
    print("READY", flush=True)
    recv.run()
    print(json.dumps({"latencies": latencies, "display_times": display_times}), flush=True)


def run_session(w: int, h: int, fps: int, frames: int, compress: str = "jpeg", fec: str = "none",
                playout_delay: float = 0.032, port: int = DEFAULT_PORT, device="cuda"):
    """The sender here, the receiver in a child process; returns the
    child's (latencies, display times)."""
    from ultragrid_tpu_torch.pipeline.sender import VideoSender

    device = torch.device(device)
    warm = f"{w}x{h}:{compress}" if is_jpeg(compress) else ""
    with tempfile.TemporaryFile(mode="w+") as err:
        child = subprocess.Popen(
            [sys.executable, "-m", "ultragrid_tpu_torch.tools.bench_latency", "--recv-child", str(frames),
             f"{playout_delay:.6f}", str(port), warm, "--device", str(device)],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=ROOT)
        try:
            line = child.stdout.readline()
            if line.strip() != "READY":
                child.wait(timeout=30)
                err.seek(0)
                raise RuntimeError(f"receiver child failed: {line!r}\n{err.read()[-2000:]}")
            sender = VideoSender(
                f"testcard:s={w}x{h}:f={fps}:c=UYVY",
                "127.0.0.1",
                compress_spec=compress,
                fec_spec=fec,
                tx_port=port,
                mtu=8192,
                frame_limit=frames + 60,
                device=device,
            )
            sender.run()
            out = child.stdout.readline()
            child.wait(timeout=30)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    res = json.loads(out)
    return res["latencies"], res["display_times"]


def summarize(w: int, h: int, fps: int, compress: str, fec: str, latencies, display_times) -> dict:
    """The reference's result (ref bench_latency.py:150-158): the first 5
    frames (first launches, cache fills) are dropped."""
    lat = np.sort(np.asarray(latencies[5:], np.float64)) * 1000.0
    span = display_times[-1] - display_times[5]
    out_fps = (len(display_times) - 6) / span if span > 0 else 0.0
    return {
        "config": f"{w}x{h}@{fps} {compress} fec={fec} localhost 2-process",
        "frames": len(lat),
        "sustained_fps": round(out_fps, 2),
        "latency_p50_ms": round(float(np.percentile(lat, 50)), 2),
        "latency_p95_ms": round(float(np.percentile(lat, 95)), 2),
        "latency_p99_ms": round(float(np.percentile(lat, 99)), 2),
        "latency_min_ms": round(float(lat[0]), 2),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args, device = device_arg(argv)
    if args and args[0] == "--recv-child":
        _recv_child(int(args[1]), float(args[2]), int(args[3]), args[4] if len(args) > 4 else "", device)
        return 0
    args, port = port_arg(args, DEFAULT_PORT)
    as_json = "--json" in args
    args = [a for a in args if a != "--json"]
    size = args[0] if len(args) > 0 else "1920x1080"
    fps = int(args[1]) if len(args) > 1 else 60
    frames = int(args[2]) if len(args) > 2 else 300
    compress = args[3] if len(args) > 3 else "jpeg"
    fec = args[4] if len(args) > 4 else "none"
    w, h = (int(x) for x in size.split("x"))

    if is_jpeg(compress):
        if not as_json:
            print(f"warming {compress} graphs at {w}x{h}...", flush=True)
        warm_graphs(w, h, compress, device)

    latencies, display_times = run_session(w, h, fps, frames, compress, fec, port=port, device=device)
    if len(latencies) < 10:
        print(json.dumps({"error": f"only {len(latencies)} frames displayed"}))
        return 1
    print(json.dumps(summarize(w, h, fps, compress, fec, latencies, display_times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
