"""Receiver-side benchmark: packets-in -> frame-displayed latency + fps.

The port of ``ultragrid_tpu/tools/bench_receiver.py``.  Runs a localhost
sender (testcard -> JPEG, kernel K1) and a receiver (dummy display) in one
process on one device (the card unless ``--device cpu``), and reports the
p50/p95 of (last-packet arrival -> display put) per frame plus sustained
receive fps.  The reference spends three threads on this path
(src/rtp/video_decoders.cpp:46-93); here it is the rx loop, the FEC thread
and the decompress thread.

The last packet's arrival is the stamp of the recvmmsg batch that brought
it: the receiver's C fast path takes each batch with its arrival time, and
with ``stamp_last_arrival`` the frame carries the stamp of the last batch
that added to it (``net/vrx_fast.py``); the reference read the same instant
off its Python packets (``max(p.arrival for p in node.packets)``).

Usage: python -m ultragrid_tpu_torch.tools.bench_receiver [WxH] [frames] [--device cpu] [--port N]
"""

from __future__ import annotations

import sys
import threading
import time

import torch

from ultragrid_tpu_torch.tools._bench import device_arg
from ultragrid_tpu_torch.tools.bench_latency import port_arg, warm_graphs

DEFAULT_PORT = 25900
GRACE_S = 10.0  # how long the receiver may trail the sender's last frame


def run(w: int, h: int, frames: int, device: torch.device, port: int = DEFAULT_PORT) -> dict:
    """The session; returns the frames shown, the receive fps and the
    latencies (ms, the first frame dropped), after printing the reference's
    line."""
    from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver
    from ultragrid_tpu_torch.pipeline.sender import VideoSender

    print("warming encode/decode graphs...", flush=True)
    warm_graphs(w, h, "jpeg", device, decode_side=True)
    latencies = []
    display_times = []
    recv = VideoReceiver("dummy", rx_port=port, frame_limit=frames + 5, timeout=180.0, device=device)
    recv.stamp_last_arrival = True
    orig_handle = recv._handle_frame

    def timed_handle(frame):
        t_last_pkt = frame.callbacks.get("last_arrival")
        ok = orig_handle(frame)
        if ok and t_last_pkt is not None:
            now = time.monotonic()
            latencies.append(now - t_last_pkt)
            display_times.append(now)
        return ok

    recv._handle_frame = timed_handle
    t = threading.Thread(target=recv.run, daemon=True)
    t.start()
    time.sleep(0.3)
    sender = VideoSender(f"testcard:s={w}x{h}:f=60:c=UYVY:still=1", "127.0.0.1", compress_spec="jpeg",
                         tx_port=port, frame_limit=frames + 10, device=device)
    sender.run()
    t.join(timeout=GRACE_S)
    recv.should_exit = True
    t.join(timeout=GRACE_S)
    res = {"frames": len(display_times), "playout_delay_ms": recv.pbuf.playout_delay * 1e3}
    if len(display_times) >= 3:
        # drop the first frame (first launches) for fps
        span = display_times[-1] - display_times[1]
        fps = (len(display_times) - 2) / span if span > 0 else 0.0
        lat = sorted(latencies[1:])
        res.update(fps=fps, p50_ms=lat[len(lat) // 2] * 1e3, p95_ms=lat[int(len(lat) * 0.95)] * 1e3,
                   latencies_ms=[x * 1e3 for x in latencies])
        print(f"receiver: {len(display_times)} frames, {fps:.1f} fps sustained, "
              f"latency last-packet->display p50={res['p50_ms']:.1f} ms p95={res['p95_ms']:.1f} ms "
              f"(includes {res['playout_delay_ms']:.0f} ms playout delay)", flush=True)
    else:
        print(f"receiver got only {len(display_times)} frames", flush=True)
    return res


def main(argv=None) -> int:
    args, device = device_arg(sys.argv[1:] if argv is None else argv)
    args, port = port_arg(args, DEFAULT_PORT)
    size = args[0] if len(args) > 0 else "1920x1080"
    frames = int(args[1]) if len(args) > 1 else 30
    w, h = (int(x) for x in size.split("x"))
    res = run(w, h, frames, device, port)
    return 0 if res["frames"] >= 3 else 1


if __name__ == "__main__":
    sys.exit(main())
