"""One run of a cell: the port's live session, driven and measured.

The sender is ``ultragrid_tpu_torch.pipeline.sender.VideoSender`` in this
process; the receiver is ``VideoReceiver`` in a second process on the same
device (:mod:`ugbench.child`).  Frames come from a capture module
registered here (``ugbench``): the seeded ring of :mod:`ugbench.content`,
each due on the camera's clock (an open loop: a late grab is stamped with
the instant it was due).

The first ``warmup_frames`` frames are set-up.  The window holds the frames
captured in the next ``seconds``; after it the capture stops, the sender
sends what it holds, and the receiver gets ``grace_s`` to show the rest.
"""

from __future__ import annotations

import multiprocessing
import threading
import time

import numpy as np

from ugbench import child, loss, trace

NS = 1_000_000_000


class Capture:
    """The registered capture device: ring frames by due time, with each
    frame's capture instant recorded."""

    def __init__(self, ring, traffic: dict, seconds: float, on_window, on_frame):
        from ultragrid_tpu_torch.types import Codec, InterlacingType, VideoDesc

        self.ring = ring
        n, h, ls = ring.shape
        self.desc = VideoDesc(ls // 2, h, Codec.UYVY, float(traffic["rate"]), InterlacingType.PROGRESSIVE, 1)
        self.period_ns = int(NS / traffic["rate"])
        self.warmup = traffic["warmup_frames"]
        self.trace_lead = traffic.get("trace_lead_frames", 30)
        self.window_frames = round(traffic["rate"] * seconds)
        self.on_window = on_window  # (event, ordinal) at "trace" and "start"
        self.on_frame = on_frame  # (ordinal, key) for every frame
        self.count = 0
        self.t_first = None
        self.t0 = None  # capture instant of the window's first frame, ns
        self.frames = []  # (ordinal, ring index, capture ns, grab ns, rtp key)
        self.finished = False
        self._last_key = None

    def grab(self):
        from ultragrid_tpu_torch.types import VideoFrame

        n = self.count
        now = time.monotonic_ns()
        # the warm-up paces from the previous slot and drops the slots a
        # stall (a first build, a cache fill) missed, as a camera does; from
        # the window's first frame the slots are fixed (an open loop): a
        # late frame is stamped with the instant it was due
        if self.t0 is None:
            due = now if self.t_first is None else max(self.t_first + self.period_ns, now)
            self.t_first = due
        else:
            due = self.t0 + (n - self.warmup) * self.period_ns
        if due > now:
            time.sleep((due - now) / NS)
        stamp = due
        if n == self.warmup - self.trace_lead or (self.trace_lead >= self.warmup and n == 0):
            self.on_window("trace", n)
        if n == self.warmup:
            self.t0 = stamp
            self.on_window("start", n)
        # the window: rate * seconds frames
        if self.t0 is not None and n >= self.warmup + self.window_frames:
            self.finished = True
            return None, None
        key = child.rtp_key(stamp / NS)
        if key == self._last_key:  # one 90 kHz tick apart: the next tick
            stamp += NS // 90000 + 1
            key = child.rtp_key(stamp / NS)
        self._last_key = key
        idx = n % self.ring.shape[0]
        frame = VideoFrame(self.desc, [self.ring[idx]])
        frame.timestamp = stamp / NS
        self.frames.append((n, idx, stamp, time.monotonic_ns(), key))
        self.on_frame(n, key)
        self.count += 1
        return frame, None

    def done(self):
        pass


class SendTap:
    """Wraps the sender session's ``send_batch``: per frame the RTP key,
    the FEC buffer's size and frame length, whether its packets cover the
    buffer whole, when its last packet left, and for sampled frames a copy
    of the buffer.  Loss (:mod:`ugbench.loss`) is applied after it."""

    def __init__(self, session, sampled_keys: set, drop):
        self.sent = {}  # key -> (done ns, buffer bytes, frame bytes, whole)
        self.buffers = {}  # key -> (buffer copy, FEC header words)
        self.sampled = sampled_keys
        send = session.send_batch

        def send_batch(ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns=0):
            data = np.asarray(data)
            offsets, sizes = np.asarray(offsets), np.asarray(sizes)
            whole = bool(sizes.sum() == data.size and offsets[0] == 0
                         and np.array_equal(offsets[1:], np.cumsum(sizes)[:-1]))
            key = int(ts) & 0xFFFFFFFF
            if key in self.sampled:
                self.buffers[key] = (data.copy(), bytes(np.asarray(hdrs[0], np.uint8)[:20]))
            hdrs, offsets, sizes = drop(hdrs, data, offsets, sizes)
            out = send(ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns)
            frame_len = int.from_bytes(data[12:16].tobytes(), "big") if data.size >= 16 else 0
            self.sent[key] = (time.monotonic_ns(), int(data.size), frame_len, whole)
            return out

        session.send_batch = send_batch


def quantile(values, q: float) -> float:
    """The nearest-rank ``q`` quantile of every value."""
    v = sorted(values)
    return float(v[max(0, min(len(v) - 1, int(np.ceil(q * len(v))) - 1))])


def start_child(cfg: dict, traffic: dict, trace_on: bool, device: str = "cuda", child_setup: str = None):
    """Start the session's second process, the receiver (it imports and
    brings up the card while this process does the same): returns (pipe
    end, process)."""
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    proc = ctx.Process(target=child.receiver_main, args=(child_conn, cfg, device, trace_on, child_setup),
                       name="ugbench-child", daemon=True)
    proc.start()
    child_conn.close()
    return conn, proc


def stop_child(conn, proc) -> None:
    if proc.is_alive():
        try:
            conn.send(("stop",))
        except OSError:
            pass
        proc.join(timeout=30)
    if proc.is_alive():
        proc.kill()
        proc.join(timeout=10)
    conn.close()


def run_cell(cfg: dict, traffic: dict, seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t_start_ns: int = None, child_setup: str = None, started=None) -> dict:
    """Run one cell; returns the raw readings (see the keys at the end).

    ``started`` is the second process from :func:`start_child`, or None to
    start it here.  ``child_setup`` ("module:function") is called in the
    second process before its receiver is built: the tests plant faults
    there."""
    t_start_ns = t_start_ns or time.monotonic_ns()
    conn, proc = started or start_child(cfg, traffic, trace_on, device, child_setup)
    try:
        return _drive(cfg, traffic, seed, seconds, trace_on, device, t_start_ns, conn, proc)
    finally:
        stop_child(conn, proc)


def _drive(cfg, traffic, seed, seconds, trace_on, device, t_start_ns, conn, proc):
    import torch

    from ugbench import content
    from ultragrid_tpu_torch.modules.registry import LibraryClass, register_module
    from ultragrid_tpu_torch.pipeline.sender import VideoSender
    from ultragrid_tpu_torch.utils import params

    stages = {"imports": time.monotonic_ns()}
    gc_pauses = trace.GcPauses()
    gc_pauses.start()
    dev = torch.device(device)
    for k, v in cfg.get("params", {}).items():
        params.set_commandline_param(k, v)
    ring = content.ring(seed, cfg["width"], cfg["height"], device=dev)
    stages["ring"] = time.monotonic_ns()
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32])
    # the frames whose output the check compares: seeded ordinals of the
    # window, and the frame of the ring index with the largest file (known
    # after the warm-up's first lap of the ring)
    warm = traffic["warmup_frames"]
    expect = int(traffic["rate"] * seconds)
    nsample = traffic["sample_frames"]
    sampled_ordinals = set((warm + rng.choice(max(expect, nsample), nsample, replace=False)).tolist())
    sampled_keys, ring_of_key = set(), {}
    largest = {"idx": None, "taken": False}
    send_lock = threading.Lock()

    def send(msg):
        with send_lock:
            conn.send(msg)

    tracer = trace.DeviceTracer()
    window_open = threading.Event()

    def on_window(event, n):
        if event == "trace" and trace_on:
            trace.zones_start()
            send(("zones",))
        if event == "start":
            window_open.set()
            sizes = {}
            for key, (_, _, flen, _) in tap.sent.items():
                sizes[ring_of_key[key]] = max(sizes.get(ring_of_key[key], 0), flen)
            largest["idx"] = max(sizes, key=sizes.get) if sizes else None
            # the window's slots are fixed: the receiver learns now which
            # frames' pictures to keep, long before they are shown
            nring = ring.shape[0]
            ords = set(sampled_ordinals)
            first = next((o for o in range(warm, warm + nring) if o % nring == largest["idx"]), None)
            if first is not None:
                ords.add(first)
            send(("keep", [child.rtp_key((cap.t0 + (o - warm) * cap.period_ns) / NS) for o in sorted(ords)]))

    def on_frame(n, key):
        idx = n % ring.shape[0]
        ring_of_key[key] = idx
        take = n in sampled_ordinals
        if n >= warm and not largest["taken"] and idx == largest["idx"]:
            largest["taken"] = take = True
        if take:
            sampled_keys.add(key)

    kind, port = conn.recv()
    stages["child_ready"] = time.monotonic_ns()
    if kind != "ready":
        raise RuntimeError(f"the receiver's process refused the run: {port}")
    cap = Capture(ring, traffic, seconds, on_window, on_frame)
    register_module("ugbench", LibraryClass.VIDEO_CAPTURE, lambda cfg_, device=None: cap)
    sender = VideoSender("ugbench", "127.0.0.1", compress_spec=cfg["compress"], fec_spec=cfg["fec"],
                         tx_port=port, mtu=cfg["mtu"], device=dev)
    k, m = (int(x) for x in cfg["fec"].split(":")[1:3])
    drop = loss.DataPacketLoss(traffic.get("loss_per_frame", 0), seed, k, m)
    tap = SendTap(sender.session, sampled_keys, drop)
    stages["sender_built"] = time.monotonic_ns()
    if trace_on and dev.type == "cuda":
        tracer.start()  # the profiler's first start takes seconds: before any traffic
        tracer.stop()
    st = threading.Thread(target=sender.run, name="ugbench-sender", daemon=True)
    st.start()
    kernels, device_slice = [], None
    if trace_on and dev.type == "cuda":
        # the device trace covers a steady slice of the window (a profile
        # of the whole window loses its device events); the profiler is
        # bound to the thread that starts it, this one
        while not window_open.wait(0.01) and st.is_alive():
            pass
        if window_open.is_set():
            a = cap.t0 + int(traffic["trace_slice"][0] * seconds * NS)
            b = a + int(min(traffic["trace_slice"][1] * seconds, traffic["trace_slice_max_s"]) * NS)
            send(("trace", a, b))
            time.sleep(max(0, a - time.monotonic_ns()) / NS)
            t_call = time.monotonic_ns()
            tracer.start()
            got_a = time.monotonic_ns()
            stages["trace_start_s"] = (got_a - t_call) / NS
            time.sleep(max(0, b - time.monotonic_ns()) / NS)
            kernels = tracer.stop()
            device_slice = (got_a, time.monotonic_ns())
    st.join()
    gc_pauses.stop()

    t0 = cap.t0
    window = [f for f in cap.frames if f[2] >= t0] if t0 is not None else []
    if cap.frames:
        stages["first_frame"] = cap.frames[0][2]
    stages["window"] = t0
    result = {"t0_ns": t0, "t_start_ns": t_start_ns, "frames_window": len(window),
              "sent": tap.sent, "stages": stages}
    # drain: the receiver stops by itself once every window frame is shown;
    # what is not shown within grace_s of the last send is not
    send(("expect", [f[4] for f in window]))
    if not conn.poll(traffic["grace_s"]):
        send(("stop",))
    kind, child_res = conn.recv()
    result["t_drain_end_ns"] = child_res.get("t_stop_ns", time.monotonic_ns())
    proc.join(timeout=30)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    zones = trace.zones_take() if trace_on else []
    if device_slice is not None and child_res.get("trace_slice"):
        # the slice both processes traced
        device_slice = (max(device_slice[0], child_res["trace_slice"][0]),
                        min(device_slice[1], child_res["trace_slice"][1]))
    mem = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0) + child_res.get(
        "memory_peak_bytes", 0)
    shown = {}
    for key, t in child_res.get("shown", []):
        shown.setdefault(key, t)
    result.update({
        "window": window, "shown": shown, "memory_peak_bytes": int(mem),
        "child": {k_: v for k_, v in child_res.items() if k_ not in ("shown", "pictures")},
        "pictures": child_res.get("pictures", {}),
        "buffers": tap.buffers, "sampled_keys": sampled_keys, "ring_of_key": ring_of_key,
        "kernels": {"sender": kernels, "receiver": child_res.get("kernels", [])},
        "device_slice": device_slice,
        "zones": {"sender": zones, "receiver": child_res.get("zones", [])},
        "gc_pauses": {"sender": gc_pauses.events, "receiver": child_res.get("gc_pauses", [])},
    })
    # the ring frames the check compares against, on the host; then the
    # program's state goes before the reference runs
    result["ring_frames"] = {ring_of_key[key]: ring[ring_of_key[key]].cpu().numpy()
                             for key in sampled_keys if key in tap.buffers}
    del sender, ring, cap
    params.reset_params()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return result

