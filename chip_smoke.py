#!/usr/bin/env python3
"""Drive the PyTorch port's sender step and its receive path on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Builds the hand-written kernels (``ultragrid_tpu_torch/csrc``), checks each
against its plain PyTorch version on the card, runs the sender step
(1920x1080 UYVY -> JPEG q80 -> LDGM 256:26:5 parity) through the port's
``EncodePipeline`` and checks that it went through both kernels, checks K2
without the staircase (the erasure peel's row XORs) on every suggested LDGM
configuration, runs the receive path (JPEG file -> LDGM -> loss -> peel on
the card -> ``JpegDecompress``) against the CPU plain path and the JPEG
entropy decode on the card against the C scan decoder, runs the
batched sender (B frames, one K1 and one K2 launch: 4K at B = 16, 8K at
B = 4, 1920x1088 4:2:0 at B = 3) against single-frame steps, every pixel
format conversion, DXT, and ``EncodePipeline`` for compress none / dxt1 /
dxt5 with LDGM and RS and with ``scale_to`` against the CPU plain path;
then the local loop, which runs no hand kernel: every postprocess function
at 1080p and 4K, every filter name at 1080p, and ``run_local_pipeline``
(4K60 testcard -> deinterlace:blend,mirror,border -> scale:1920x1080 ->
display, 120 frames) with stitch and conference, each against the CPU plain
path; K1's per-plane entry (the JPEG geometries without a mega matrix,
frame bytes in, slots out) against its plain version at 1080p and 4K; the own H.264 encoders at 1080p on the card
against the same modules on the CPU (byte-equal access units, every decoded
frame equal to the encoder's reference picture, the all-tie case) with their
timing rows; then the live session through the port's entry
points: sender -> 127.0.0.1 UDP -> receiver at 1080p60, JPEG + LDGM with
seeded packet loss (the receiver's peel on the card) and uncompressed + LDGM,
``--protocol loopback`` with JPEG 4:4:4 at 1080p and 4K60, the H.264 inter + LDGM session with
seeded loss (every displayed frame equal to the sender's reference picture)
and H.264 loopbacks, the wavelet and intra codecs (JPEG XS, CineForm CFHD
and UCF1, APV, JPEG 2000: phase ``codecs``, card against CPU byte for byte
with the reference tests' golden digests; ``-c jpegxs`` and ``-c openapv``
+ LDGM sessions with seeded loss, and loopbacks), JPEG rate control against
its CPU quality sequence, and a 4K timing row; audio in the live session
(phase ``audio_session``: the 1080p60 JPEG + LDGM session with ``-s
testcard:frequency=997 -f A:rs:16:24 -r wav``, one audio packet dropped a
frame, every played audio frame equal to the one sent under its RTP
timestamp; the same without audio and with the reference's
``A:rs:200:240``; ``--audio-delay`` on the receiver the CLI builds; ``-E``
on a 1080p60 sender, its frames through ``ImportCapture`` on the card and
replayed as ``-I``'s capture with their embedded audio; the audio RS parity
on the card against the CPU's; the CLI's receiver and sender in two
processes); standards mode, RTSP, the duplex call, the preview socket and
iHDTV at 1080p (phase ``standards``: the ``--rtp-standard`` session, every
shown frame the CPU decode of the file sent under its RTP timestamp; a
``--rtsp`` sender and ``RtspCapture`` on the card into a local loop; RTSP
capture of an H.264 camera stream at 15 frames/s and at 30 (every access
unit), every frame the encoder's reference picture; the duplex call through
``cli.main`` with and without ``--echo-cancellation``; ``-F preview`` with
thumbnailgen on the card,
byte-equal to the CPU's thumbnails; ``-x ihdtv``, frames byte-equal); and
times kernels, steps, the receive step, the 4K batch in frames/s,
4K latency, conversions, DXT, the postprocess functions and the loop's
chain.  Every phase prints one JSON line; any failed
check raises, so the exit code is non-zero.  The last lines are the kernel
table, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  Phase ``parallel`` runs the multi-device path (``parallel/``) at
8K UYVY as four row bands on one card: the sender and receiver steps (K1
and K2 per band, the peel per band) against single-band encodes, K2's plain
version, the CPU port and the unsharded decode, ``ShardedJpegDecoder``, the
halo deinterlace, sharded H.264 at 1080p x 4, the dry run, and the file
capture and display modules; with four cards present, the 8K JPEG + LDGM
live session split over them by row band (``--param cuda-device=0,1,2,3``,
120 frames; ``--only banded_session`` runs it alone), gated on K1 once a
card and frame sent, the decode once a card and frame shown and never
refused, sent files byte-equal to the one-card encode and shown frames
bit-equal to the one-card decode.  Phase ``tools`` runs the port's bench tools
(``ultragrid_tpu_torch/tools/bench_*.py``) at the reference tools' own
sizes, each kernel row against its plain version and each tool's output
against the CPU port's, with bench_latency's two-process 1080p60 session
gated on every frame shown; then the screen capture from a mock X server,
``ug_input`` fed by an uncompressed sender, v4l2's probe and the hardware
stubs.  Phase ``remaining`` runs the last slice: the 1080p60 JPEG + LDGM
session with loss into ``-d x11`` against the mock X server (every window
image the CPU port's rendering of the CPU decode of its file),
``hd_rum_translator`` with a ``-c jpeg`` and a raw client, ``tools/convert.py``
at 4K against the CPU, the libavcodec rows where libavcodec's headers are
present (one line saying they are absent otherwise), and ``-t camera``
through a ``.ug.rc`` alias.  Phase ``api`` runs the names that close the
port's public API at 1080p: ``JpegEncoder.warm`` before an escalation
forced on a noise frame (K1 and its per-plane entry; the file against the
plain version on the card and the CPU), ``jpeg_encode_core`` (one K1 launch
a call, its parts assembling to the CPU's file), and ``lavc_encoders()``
with the registered audio codecs.  ``python3 chip_smoke.py --only
standards`` (or ``--only parallel``, ``--only tools``, ``--only
remaining``, ``--only api``, ``--only card_decode``, ``--only assemble``) builds the kernels and runs
that phase alone, printing no result line.  Phase ``assemble`` checks the
sender's entropy assembly on the card (``csrc/jpeg_assemble.cu``) against
the host C assembly at 1080p, 4K and an 8K band, at q80 and q95, and an
escalation; the LDGM buffer built on the card against the host's; and the
1080p60 JPEG + LDGM session on one card with every frame's file assembled
and its LDGM buffer built on the card.

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# 1080p: the sender step of __graft_entry__.entry(); 4K and 8K (7680x2160,
# the reference's north-star geometry) for timing
W1080, H1080 = 1920, 1080
W4K, H4K = 3840, 2160
W8K, H8K = 7680, 2160
SMALL = (1024, 512)  # the other K1 layouts
FEC = "ldgm:256:26:5"
MAX_DIFF_BLOCK_SHARE = 0.001  # real W vs the plain version on the card: <= 0.1% of blocks
# the decoder's float32 product on the card (torch.matmul) against the plain
# chain: <= 0.1% of output bytes differing, each by at most 1
MAX_DIFF_BYTE_SHARE = 0.001
# the batched sender: (label, width, height, frames, subsampling); 4K at 16
# as bench.py's throughput metric, 8K at 4, 4:2:0 needs 16-row MCUs
BATCHES = [("4K", 3840, 2160, 16, None), ("8K", 7680, 2160, 4, None), ("1088p 4:2:0", 1920, 1088, 3, "420")]
LATENCY_RUNS = 60  # bench.py's single-frame 4K latency sample
# receive path: LDGM 256:26:5 over the 1080p file, seeded losses; 8 lost
# symbols are recovered (in 2 peel rounds), 40 are not
LOSS_RECOVERED, LOSS_UNRECOVERABLE = 8, 40
TIMING_RUNS = 100  # back-to-back launches per event-timed reading
PLAIN_RUNS = 5     # the plain versions are slow; fewer runs
# one H100 SXM (NVIDIA's data sheet, dense rates): HBM rate and the
# FP32 rate outside the tensor cores, also taken for the 32-bit XORs of K2
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def content(h: int, linesize: int, seed: int):
    """Gradient plus sensor-like noise, limited range (as bench.py)."""
    rng = np.random.default_rng(seed)
    base = np.linspace(0, 255, linesize, dtype=np.float32)[None, :] + rng.normal(0, 8, (h, linesize))
    return base.clip(16, 235).astype(np.uint8)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def differing_blocks(a, b) -> int:
    """Blocks whose slot words or bit count differ between two encodes."""
    n = 0
    for slots, bits in ((0, 1), (2, 3), (4, 5)):
        row_diff = (a[slots] != b[slots]).any(dim=1) | (a[bits] != b[bits])
        n += int(row_diff.sum())
    return n


def max_abs_err(a, b) -> int:
    """Largest |a - b| over paired integer tensors."""
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0 for x, y in zip(a, b))


def cuda_ms(fn, runs: int = TIMING_RUNS, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``runs`` back-to-back calls of fn(),
    between two CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / runs


def device_kernels(fn, runs: int = 20, attempts: int = 5, warmup: bool = True, expect: str = ""):
    """{kernel name: (launches per call, device ms per call)} of fn() from
    torch.profiler's device-side events, after one warm-up call (unless
    ``warmup`` is False).  The profiler may drop events of some calls
    (:func:`per_step` corrects for it) and, now and then, returns no device
    events at all, or none of one kernel's; such a profile (no events, or
    none whose name holds ``expect``, without regard to case) is taken
    again, up to ``attempts`` times."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        out = kernel_table(prof, runs)
        if out and any(expect.lower() in k.lower() for k in out):
            break
    return out


def kernel_table(prof, runs: int):
    """{kernel name: (launches per call, device ms per call)} of a finished
    profile of ``runs`` calls: the device's kernels and copies, not the span
    of a profiler step (``ProfilerStep#``), which it also shows on the
    device."""
    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA or evt.key.startswith("ProfilerStep"):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        out[evt.key] = (evt.count / runs, us / 1000.0 / runs)
    return out


def per_step(ks, anchor: str, times: int = 1):
    """(launches, device ms) per call from device_kernels' result, scaled by
    the kernel ``anchor``, which fn() launches exactly ``times`` times per
    call (the profiler may drop events of some calls, but all of a call's
    alike).  ``anchor`` is matched without regard to case."""
    hits = [c for k, (c, _) in ks.items() if anchor in k.lower()]
    if not hits or hits[0] <= 0:
        raise RuntimeError(f"profiler saw no {anchor} kernel (saw {sorted(ks)})")
    scale = times / hits[0]
    return (sum(c for c, _ in ks.values()) * scale, sum(ms for _, ms in ks.values()) * scale)


def kernel_device_ms(fn, name: str, runs: int = 20) -> float:
    """Device time per launch of the kernel of fn() whose name holds ``name``."""
    ks = device_kernels(fn, runs, expect=name)
    hits = [(c, ms) for k, (c, ms) in ks.items() if name in k]
    if not hits or hits[0][0] <= 0:
        raise RuntimeError(f"profiler saw no {name} kernel (saw {sorted(ks)})")
    return hits[0][1] / hits[0][0]


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, what bounds it): bytes over the memory rate or
    operations over the FP32 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def k1_work(enc):
    """(bytes, FLOP) that one K1 call over enc's frame needs: each frame byte
    of the MCUs and the compact plan read once, the slots and bit counts
    written once; two FLOP per needed multiply-add (nmcu * sum |S_g| * 64)."""
    rows, groups, wc = enc.plan
    ww, nb = enc.wwords, enc.nblocks
    tables = wc.nbytes + rows.nbytes + groups.nbytes + 4 * (64 * enc.blocks_per_mcu + 544)
    nbytes = enc.height * enc.nmcux * enc.bpr + tables + nb * (ww + 1) * 4 + 1
    fma = enc.nmcu * int(groups[:, 2].sum()) * 64
    return nbytes, 2 * fma


def k2_work(par):
    """(bytes, XORs) of one K2 call over all its frames: the parts read
    once, the parities written once; one XOR per member word of every parity
    row of every frame."""
    nbytes = 4 * par.frames * (sum(par.part_words) + par.m * par.psw) + par.row_ptr.nbytes + par.cols.nbytes
    return nbytes, len(par.cols) * par.psw * par.frames


def k2_peel_work(par):
    """(bytes, XORs) of one K2 call of the peel: the symbol block read
    once, the m raw rows written once, the member lists read once."""
    nbytes = 4 * (par.rows * par.psw + par.m * par.psw) + par.row_ptr.nbytes + par.cols.nbytes
    return nbytes, len(par.cols) * par.psw


def k2_peel_case(sess, block, what: str):
    """K2 without the staircase (the peel's row XORs over the full check
    matrix) and with it (``LdgmSession.encode_device``) on one symbol block
    on the card against their plain versions, bit for bit: (max abs error,
    the case's row)."""
    from ultragrid_tpu_torch.ops.fec import Gf2Parity, symbol_words

    words = symbol_words(block)
    par = sess.peel_parity(block.device)[0].with_width(words.shape[1])
    got, want = par(words), par.plain(words)
    err = max_abs_err([got], [want])
    if not torch.equal(got, want):
        raise RuntimeError(f"K2 without staircase, {what}: differs from its plain version")
    data = block[: sess.k]
    enc_got = sess.encode_device(data)
    enc_want = Gf2Parity(sess.matrix, words.shape[1]).plain(symbol_words(data))
    if not torch.equal(enc_got, enc_want.view(torch.uint8)[:, : block.shape[1]]):
        raise RuntimeError(f"K2 with staircase (encode_device), {what}: differs from its plain version")
    return err, {"case": what, "rows": par.rows, "m": par.m, "psw": par.psw, "members": len(par.cols),
                 "bit_equal": True}


def lose(buf, ps, nloss, seed):
    """(symbols with ``nloss`` seeded rows zeroed, presence flags)."""
    sym = buf.reshape(-1, ps).copy()
    lost = np.random.default_rng(seed).choice(sym.shape[0], nloss, replace=False)
    present = np.ones(sym.shape[0], bool)
    present[lost] = False
    sym[lost] = 0
    return sym, present


def psnr(a, b) -> float:
    """PSNR in dB of two uint8 tensors of one shape."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def byte_diff(a, b):
    """(differing bytes, largest |a - b|) of two uint8 tensors."""
    d = (a.cpu().long() - b.cpu().long()).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def host_ms(fn, runs: int, warmup: bool = True) -> float:
    """Mean host milliseconds per call of fn() (which synchronises), after
    one warm-up call unless ``warmup`` is False."""
    if warmup:
        fn()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) * 1e3 / runs


def blocks_differing(a, b, bpb: int) -> int:
    """Blocks of ``bpb`` bytes that differ between two uint8 tensors."""
    return int((a.cpu().reshape(-1, bpb) != b.cpu().reshape(-1, bpb)).any(dim=1).sum())


def profile_row(what, fn, anchor=None):
    """Device time and launches per call of fn() by the profiler, the host
    clock back to back, and CUDA events."""
    ks = device_kernels(fn, runs=10, expect=anchor or "")
    launches = sum(c for c, _ in ks.values())
    dev_ms = sum(ms for _, ms in ks.values())
    if anchor is not None:
        launches, dev_ms = per_step(ks, anchor)
    return {"what": what, "device_ms": dev_ms, "launches_per_step": launches,
            "ms": cuda_ms(fn, runs=20), "host_ms": host_ms(lambda: (fn(), torch.cuda.synchronize()), runs=20)}


def plain_step(pipe, frame):
    """The pipeline's step through the plain versions of K1 and K2."""
    outs = pipe.jpeg_encoder.encode_plain(frame)
    par = pipe.parity.plain(*outs[:6])
    return (*outs[:6], par.view(torch.uint8).reshape(pipe.m, pipe.ps), outs[6])


# ---- slice 5: postprocess, filters and the local loop (no hand kernel) ----

LOOP_CAPTURE = "testcard:s=3840x2160:f=60:c=UYVY"
LOOP_FILTER = "deinterlace:blend,mirror,border"
LOOP_POSTPROCESS = "scale:1920x1080"
LOOP_FRAMES = 120
BT601 = np.array([[0.299, 0.587, 0.114], [0.5, -0.4187, -0.0813], [-0.1687, -0.3313, 0.5]])
Y601_TO_Y709 = np.array([1, -0.11555, -0.207938, 0, 1.01864, 0.114618, 0, 0.075049, 1.025327])


def postprocess_cases(w: int, h: int):
    """(name, codec, call(src) -> tensor or tuple) for every function of the
    port's ops/postprocess.py on each codec it takes, at w x h."""
    from ultragrid_tpu_torch.ops import postprocess as pp
    from ultragrid_tpu_torch.types import Codec

    logo = np.random.default_rng(50).integers(0, 256, (128, 256, 4), dtype=np.uint8)
    packed = (Codec.UYVY, Codec.RGB, Codec.RGBA, Codec.v210)
    cases = []
    for c in packed:
        cases += [("deinterlace_blend", c, lambda s, c=c: pp.deinterlace_blend(s, c)),
                  ("deinterlace_linear", c, lambda s, c=c: pp.deinterlace_linear(s, c)),
                  ("crop", c, lambda s, c=c: pp.crop(s, w, c, 96, 40, w // 2, h // 2)),
                  ("mirror", c, lambda s, c=c: pp.mirror(s, w, c)),
                  ("blank_region", c, lambda s, c=c: pp.blank_region(s, w, c, 96, 40, w // 3, h // 3, 200)),
                  ("scale_nearest", c, lambda s, c=c: pp.scale_nearest(s, w, c, w // 2, h // 2))]
    for name in ("deinterlace_bob_even", "deinterlace_bob_odd", "interlace", "flip"):
        cases.append((name, Codec.UYVY, lambda s, f=getattr(pp, name): f(s)))
    cases.append(("fields_to_frames", Codec.UYVY, lambda s: pp.fields_to_frames(s, Codec.UYVY)))
    cases.append(("grayscale", Codec.UYVY, lambda s: pp.grayscale(s, w, Codec.UYVY)))
    for c in (Codec.RGB, Codec.RGBA):
        cases += [("gamma_correct", c, lambda s: pp.gamma_correct(s, 2.2)),
                  ("grayscale", c, lambda s, c=c: pp.grayscale(s, w, c)),
                  ("color_matrix", c, lambda s, c=c: pp.color_matrix(s, w, c, BT601)),
                  ("logo_blit", c, lambda s, c=c: pp.logo_blit(s, w, c, logo, 64, 32)),
                  ("scale_bilinear_rgb", c, lambda s, c=c: pp.scale_bilinear_rgb(s, w, c, w // 2, h // 2))]
    cases.append(("matrix2_uyvy", Codec.UYVY, lambda s: pp.matrix2_uyvy(s, w, Y601_TO_Y709)))
    return cases


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# CUDA runtime calls that put work on the device, as the profiler's CPU side
# names them; unlike the device-side events the profiler drops none of them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def eager_row(what, fn, runs: int = 20):
    """Device time and launches per call of fn(), an eager chain of small
    launches, with no one kernel to anchor :func:`per_step`: launches are
    the CUDA runtime launch calls the profiler's CPU side counts; the device
    events it saw are scaled up by launch calls over device events (the
    profiler drops device events of some calls, of every call alike).  Host
    clock back to back and CUDA events beside them; idle share = 1 - device
    over host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    n_launch, n_dev, dev_us = 0, 0, 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            n_dev += evt.count
            us = getattr(evt, "self_device_time_total", None)
            dev_us += evt.self_cuda_time_total if us is None else us
        elif evt.key.startswith(LAUNCH_CALLS):
            n_launch += evt.count
    scale = n_launch / n_dev if n_dev else 0.0
    dev_ms = dev_us / 1000.0 / runs * scale
    host = host_ms(lambda: (fn(), torch.cuda.synchronize()), runs=runs)
    return {"what": what, "device_ms": dev_ms, "launches_per_step": n_launch / runs,
            "device_events_seen": n_dev / runs, "ms": cuda_ms(fn, runs=runs), "host_ms": host,
            "idle_share": max(0.0, 1 - dev_ms / host)}


def card_decode_rows(dev):
    """The JPEG entropy decode on the card (``csrc/jpeg_decode.cu``) against
    the C scan decoder and against its plain version on the same card
    inputs: q equal to both, the status word equal to the plain version's,
    and ``JpegDecoder.decode_to_uyvy``'s card route byte-equal to its C
    route, one launch a frame; the kernels' device time beside their byte
    bound, the whole route's host time, the C route's and the plain
    version's on the card.  The receive path's streams: 1080p and 4K q80 at the default
    restart interval, 1080p q95 with a marker after every MCU, a small odd
    size at q50, and noise at q100 (more exceptions than the packed
    upload takes)."""
    from ultragrid_tpu_torch.ops import jpeg_decode_cuda
    from ultragrid_tpu_torch.ops.jpeg import (JpegDecoder, JpegEncoder, _parse_headers,
                                              entropy_decode_422)
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize
    from ultragrid_tpu_torch.utils import profiler

    cases = [("1080p q80", 1920, 1080, 80, None, False), ("4K q80", 3840, 2160, 80, None, False),
             ("1080p q95 ri=1", 1920, 1080, 95, 1, False), ("208x56 q50", 208, 56, 50, None, False),
             ("512x128 q100 noise", 512, 128, 100, None, True)]
    rows = []
    torch.cuda.synchronize()
    jpeg_decode_cuda.LAUNCHES.reset()
    for what, w, h, q, ri, noise in cases:
        ls = vc_get_linesize(w, Codec.UYVY)
        src = (np.random.default_rng(5).integers(0, 256, (h, ls), dtype=np.uint8) if noise
               else content(h, ls, 5))
        data = bytes(JpegEncoder(w, h, quality=q, restart_interval=ri).encode(src, device="cpu"))
        hdr, (cy, cu, cv), nmcux, nmcuy = entropy_decode_422(data)
        nmcu = nmcux * nmcuy
        nseg = -(-nmcu // hdr["ri"])
        want_q = torch.cat([torch.as_tensor(cy).view(nmcu, 128), torch.as_tensor(cu), torch.as_tensor(cv)],
                           1).float()
        file = torch.zeros(len(data) + jpeg_decode_cuda.PAD, dtype=torch.uint8, device=dev)
        file[: len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
        tables = torch.as_tensor(jpeg_decode_cuda.huffman_tables(hdr["htabs"])).to(dev)
        tds = tuple(c["td"] for c in _parse_headers(data)["scan"])

        def kernel():
            return jpeg_decode_cuda.segment_decode(file, len(data), hdr["scan_start"], tables, tds, nmcu, hdr["ri"])

        before = jpeg_decode_cuda.LAUNCHES.count
        got_q, status = kernel()
        torch.cuda.synchronize()
        if jpeg_decode_cuda.LAUNCHES.count != before + 1:
            raise RuntimeError(f"card decode {what}: the wrapper did not launch the kernel")
        if status.tolist() != [0, nmcu, nseg - 1, 0]:
            raise RuntimeError(f"card decode {what}: status {status.tolist()}, expected [0, {nmcu}, {nseg - 1}, 0]")
        q_off = int((got_q.cpu() != want_q).sum())
        if q_off:
            raise RuntimeError(f"card decode {what}: {q_off} coefficients differ from the C decoder's")

        def plain():
            return jpeg_decode_cuda.segment_decode_plain(file, len(data), hdr["scan_start"], tables, tds, nmcu,
                                                         hdr["ri"])

        t0 = time.perf_counter()
        plain_q, plain_status = plain()
        torch.cuda.synchronize()
        plain_ms = [(time.perf_counter() - t0) * 1e3]
        plain_off = int((plain_q != got_q).sum())
        if plain_off or plain_status.tolist() != status.tolist():
            raise RuntimeError(f"card decode {what}: {plain_off} coefficients and status {plain_status.tolist()} "
                               f"of the plain version differ from the kernel's")
        dec = JpegDecoder(dev)
        before = jpeg_decode_cuda.LAUNCHES.count
        frames = 3
        for _ in range(frames):
            card = dec.decode_to_uyvy(data)
        launches = jpeg_decode_cuda.LAUNCHES.count - before
        host = dec._decode_on_host(data)
        torch.cuda.synchronize()
        if launches != frames or dec.host_scans != 1 or card[1:] != host[1:]:
            raise RuntimeError(f"card decode {what}: {launches} launches for {frames} frames, "
                               f"{dec.host_scans} host scans, shapes {card[1:]} / {host[1:]}")
        nd, err = byte_diff(card[0], host[0])
        if nd:
            raise RuntimeError(f"card decode {what}: {nd} bytes differ from the C route (max {err})")
        ks = device_kernels(kernel, runs=20, expect="jpeg_segment_decode_kernel")
        parts = {}
        for name in ("jpeg_rst_count_kernel", "jpeg_rst_place_kernel", "jpeg_segment_decode_kernel", "Memset"):
            hits = [ms / c for k, (c, ms) in ks.items() if name in k and c > 0]
            if not hits:
                raise RuntimeError(f"card decode {what}: profiler saw no {name} (saw {sorted(ks)})")
            parts[name] = hits[0]
        nbytes = len(data) + nmcu * 256 * 4
        bms, by = bound_ms(nbytes, 0)
        device_ms = sum(parts.values())
        # the card route's stages by the program's own spans, 20 frames
        profiler.enabled = True
        profiler._events.clear()
        for _ in range(20):
            dec.decode_to_uyvy(data)
        spans = {}
        for n, _tid, _t0, dur in profiler._events:
            spans.setdefault(n, []).append(dur / 1e6)
        profiler.enabled = False
        profiler._events.clear()
        row = {"what": f"jpeg_decode {what} ({w}x{h}, restart interval {hdr['ri']}, {nseg} segments)",
               "jpeg_bytes": len(data), "q_mbytes": nmcu * 1024 / 1e6, "status": status.tolist(),
               "q_differing": q_off, "pixels_differing_from_c_route": nd, "launches_per_frame": launches / frames,
               "kernels_ms": parts, "segment_decode_ms": parts["jpeg_segment_decode_kernel"],
               "device_ms": device_ms, "bound_ms": bms, "bound_by": by, "share_of_bound": bms / device_ms,
               "card_route_host_ms": host_ms(lambda: dec.decode_to_uyvy(data), runs=20),
               "card_route_spans_ms": {n: sum(v) / len(v) for n, v in spans.items()},
               "c_route_host_ms": host_ms(lambda: (dec._decode_on_host(data), torch.cuda.synchronize()), runs=10)}
        if w >= 1920 and ri is None:
            t0 = time.perf_counter()
            plain()
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            row["plain_on_card_ms"] = min(plain_ms)
        row["q_differing_from_plain"] = plain_off
        rows.append(row)
    return rows


def phase_postprocess(dev):
    """Every postprocess function at 1080p and 4K on the card against the
    CPU plain path (byte-equal; add_noise: within its amount and in 0..255),
    and a timing row per function at 4K on its first codec."""
    from ultragrid_tpu_torch.ops import postprocess as pp
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize

    t0 = time.perf_counter()
    checked, rows, worst = 0, [], (0, 0)
    for w, h in ((W1080, H1080), (W4K, H4K)):
        timed, srcs = set(), {}
        for name, codec, call in postprocess_cases(w, h):
            if codec not in srcs:  # random bytes: every value of every component
                src = torch.as_tensor(np.random.default_rng(51 + int(codec)).integers(
                    0, 256, (h, vc_get_linesize(w, codec)), dtype=np.uint8))
                srcs[codec] = (src, src.to(dev))
            src, src_d = srcs[codec]
            got, want = as_tuple(call(src_d)), as_tuple(call(src))
            for g, c in zip(got, want):
                if not g.is_cuda or g.shape != c.shape:
                    raise RuntimeError(f"postprocess {name} {codec.name} {w}x{h}: {g.device} "
                                       f"{tuple(g.shape)} vs {tuple(c.shape)}")
                nd, err = byte_diff(g, c)
                worst = max(worst, (nd, err))
                if nd:
                    raise RuntimeError(f"postprocess {name} {codec.name} {w}x{h}: {nd} bytes differ "
                                       f"from the CPU plain path (max {err})")
            checked += 1
            if w == W4K and name not in timed:
                timed.add(name)
                rows.append(eager_row(f"{name} 4K {codec.name}", lambda: call(src_d)))
        src_d = srcs[Codec.UYVY][1]
        gen = torch.Generator(device=dev).manual_seed(1)
        noisy = pp.add_noise(src_d, gen, 16)
        d = noisy.long() - src_d.long()
        again = pp.add_noise(src_d, torch.Generator(device=dev).manual_seed(1), 16)
        if not noisy.is_cuda or int(d.abs().max()) > 16 or not torch.equal(noisy, again):
            raise RuntimeError(f"add_noise {w}x{h}: outside +-16 or not deterministic on the card")
        checked += 1
        if w == W4K:
            rows.append(eager_row("add_noise 4K UYVY", lambda: pp.add_noise(src_d, gen, 16)))
    return {"phase": "postprocess", "seconds": time.perf_counter() - t0, "cases": checked,
            "bytes_differing": worst[0], "max_abs_err": worst[1],
            "add_noise": "within +-16, deterministic per seed", "timing_4k": rows}


FILTER_SPECS = [  # (spec, codec, frames): every name of _FILTERS once
    ("scale:960x540", "UYVY", 1), ("resize:960:540", "UYVY", 1), ("deinterlace", "UYVY", 1),
    ("deinterlace_blend", "UYVY", 1), ("deinterlace_linear", "UYVY", 1), ("deinterlace_bob", "UYVY", 1),
    ("interlace", "UYVY", 1), ("crop:1280:720:16:8", "UYVY", 1), ("mirror", "UYVY", 1), ("flip", "UYVY", 1),
    ("gamma:2.2", "RGB", 1), ("grayscale", "RGB", 1),
    ("matrix:0.393:0.769:0.189:0.349:0.686:0.168:0.272:0.534:0.131", "RGB", 1),
    ("blank:64:64:320:200", "UYVY", 1), ("noise:16", "UYVY", 1), ("every:2", "UYVY", 3),
    ("disrupt:drop=50", "UYVY", 4), ("ratelimit:1000", "UYVY", 1), ("logo", "RGB", 1),
    ("change_pixfmt:RGB", "UYVY", 1), ("border:color=ff0000:width=16:height=12", "UYVY", 1),
    ("split:2x2", "UYVY", 1), ("delay:frames=2", "UYVY", 3), ("double_framerate:force", "UYVY", 1),
    ("temporal_deint:force", "UYVY", 1), ("text:x=40:y=40:h=32:t=UltraGrid", "UYVY", 1),
    ("interlaced_3d", "UYVY", 1), ("3d-interlaced", "UYVY", 1), ("add_frame:every=2", "UYVY", 2),
    ("matrix2:y601_to_y709", "UYVY", 1), ("override_prop:fps=50i:size=1920x1080", "UYVY", 1),
    ("color", "UYVY", 1), ("temporal_3d", "UYVY", 2), ("display:dummy", "UYVY", 1), ("preview", "UYVY", 1),
]


def phase_filters(dev):
    """Every registered filter name on 1920x1080 testcard frames on the
    card: each output tile on the card and equal to the CPU chain; split:2x2
    -> vf_merge_tiles and temporal_3d -> interlaced_3d."""
    from ultragrid_tpu_torch.modules import filters
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
    from ultragrid_tpu_torch.utils.pattern import generate_pattern
    from ultragrid_tpu_torch.utils.tiling import vf_merge_tiles

    t0 = time.perf_counter()
    patterns = ("smpte_bars", "bars", "gradient", "noise")
    srcs = {}

    def frames(codec, n, device):
        out = []
        for i in range(n):
            key = (codec, i)
            if key not in srcs:
                srcs[key] = generate_pattern(W1080, H1080, Codec[codec], patterns[i % 4], seed=i, device=dev)
            f = VideoFrame(VideoDesc(W1080, H1080, Codec[codec], 60.0), [srcs[key].to(device)])
            f.timestamp = float(i)
            out.append(f)
        return out

    def flat(r):
        return [] if r is None else r if isinstance(r, list) else [r]

    names = set()
    outputs = 0
    for spec, codec, n in FILTER_SPECS + [("split:2x2", "UYVY", 1), ("temporal_3d,interlaced_3d", "UYVY", 2)]:
        names.update(part.partition(":")[0] for part in spec.split(","))
        gpu, cpu = filters.FilterChain(spec), filters.FilterChain(spec)
        for fg, fc in zip(frames(codec, n, dev), frames(codec, n, "cpu")):
            got, want = flat(gpu.apply(fg)), flat(cpu.apply(fc))
            if len(got) != len(want):
                raise RuntimeError(f"filter {spec}: {len(got)} frames on the card, {len(want)} on the CPU")
            for g, c in zip(got, want):
                if spec == "split:2x2":
                    g, c = vf_merge_tiles(g, 2, 2), vf_merge_tiles(c, 2, 2)
                    if not torch.equal(g.data, fg.data):
                        raise RuntimeError("split:2x2 -> vf_merge_tiles is not the input frame")
                for tg, tc in zip(g.tiles, c.tiles):
                    if not tg.is_cuda:
                        raise RuntimeError(f"filter {spec}: output tile on {tg.device}, not on the card")
                    if spec.startswith("noise"):
                        ok = int((tg.long() - fg.data.long()).abs().max()) <= 16
                    else:
                        ok = tg.shape == tc.shape and byte_diff(tg, tc)[0] == 0
                    if not ok:
                        raise RuntimeError(f"filter {spec}: the card differs from the CPU chain")
                outputs += 1
    missing = set(filters._FILTERS) - names
    if missing:
        raise RuntimeError(f"filters not run: {sorted(missing)}")
    return {"phase": "filters", "seconds": time.perf_counter() - t0, "geometry": f"{W1080}x{H1080}", "names": len(names & set(filters._FILTERS)),
            "outputs_checked": outputs, "all_on_card": True, "bytes_differing": 0,
            "noise": "within +-16", "split_merge_and_temporal_3d_interlaced_3d": True}


def phase_local_loop(dev):
    """The slice's main path: run_local_pipeline on the card, 120 frames of
    the 4K60 testcard through deinterlace:blend,mirror,border and
    scale:1920x1080, once to a pipe display (every frame on the card and
    equal to the CPU plain path of the same chain on the same ring frame)
    and once to dummy:codec=RGB (the UYVY -> RGB conversion; frames shown,
    frames/s against the 60 fps pace); the chain's device time, launches
    and host time per frame; stitch and conference against the CPU."""
    from ultragrid_tpu_torch.modules.extra_displays import register_pipe_delegate
    from ultragrid_tpu_torch.modules.filters import FilterChain
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.modules.video_display import initialize_video_display
    from ultragrid_tpu_torch.ops import fec as fec_ops
    from ultragrid_tpu_torch.ops import jpeg_cuda
    from ultragrid_tpu_torch.ops.pixfmt import convert_frame
    from ultragrid_tpu_torch.pipeline.loop import CaptureToDisplayPipeline, run_local_pipeline
    from ultragrid_tpu_torch.types import Codec, VideoFrame

    t_phase = time.perf_counter()
    kept = []
    register_pipe_delegate("chip_smoke", kept.append)
    torch.cuda.synchronize()
    jpeg_cuda.LAUNCHES.reset()
    fec_ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    n = run_local_pipeline(LOOP_CAPTURE, "pipe:chip_smoke", LOOP_FRAMES, LOOP_FILTER, LOOP_POSTPROCESS)
    torch.cuda.synchronize()
    pipe_s = time.perf_counter() - t0
    hand = {"jpeg_encode": jpeg_cuda.LAUNCHES.count, "gf2_parity": fec_ops.LAUNCHES.count}
    frames = kept[:-1]
    if n != LOOP_FRAMES or len(frames) != LOOP_FRAMES or kept[-1] is not None:
        raise RuntimeError(f"local loop to pipe: {n} captured, {len(frames)} shown")
    # the CPU plain path: the same testcard ring and chain on the host
    cap_cpu = initialize_video_capture(LOOP_CAPTURE, device="cpu")
    ring = len(cap_cpu.frames)
    want = []
    for i in range(ring):
        f = VideoFrame(cap_cpu.desc, [cap_cpu.frames[i]])
        want.append(FilterChain(LOOP_POSTPROCESS).apply(FilterChain(LOOP_FILTER).apply(f)).data)
    for i, f in enumerate(frames):
        if not f.data.is_cuda:
            raise RuntimeError(f"local loop frame {i} on {f.data.device}, not on the card")
        if f.data.shape != want[i % ring].shape or byte_diff(f.data, want[i % ring])[0]:
            raise RuntimeError(f"local loop frame {i} differs from the CPU plain path")
    kept.clear()
    # to dummy:codec=RGB: the UYVY -> RGB conversion, frames/s against the pace
    cap = initialize_video_capture(LOOP_CAPTURE)
    disp = initialize_video_display("dummy:codec=RGB")
    pipe = CaptureToDisplayPipeline(cap, disp, LOOP_FRAMES, LOOP_FILTER, LOOP_POSTPROCESS)
    t0 = time.perf_counter()
    n_rgb = pipe.run()
    torch.cuda.synchronize()
    rgb_s = time.perf_counter() - t0
    if n_rgb != LOOP_FRAMES or disp.frames_shown != LOOP_FRAMES or disp.desc.color_spec != Codec.RGB:
        raise RuntimeError(f"local loop to dummy:codec=RGB: {n_rgb} captured, {disp.frames_shown} shown")
    # one frame of the chain: capture filters + scale + conversion
    src = VideoFrame(cap.desc, [cap.frames[0]])

    def chain():
        return pipe.convert(pipe.postprocess_chain.apply(pipe.capture_chain.apply(src)))

    row = eager_row("4K UYVY: deinterlace:blend,mirror,border + scale:1920x1080 + UYVY->RGB", chain)
    parts = []
    for what, fn in (("deinterlace:blend", FilterChain("deinterlace:blend")),
                     ("mirror", FilterChain("mirror")), ("border", FilterChain("border"))):
        parts.append(eager_row(f"{what} 4K UYVY", lambda fn=fn: fn.apply(src)))
    scaled = pipe.postprocess_chain.apply(pipe.capture_chain.apply(src))
    parts.append(eager_row("scale:1920x1080 from 4K UYVY", lambda: pipe.postprocess_chain.apply(src)))
    parts.append(eager_row("UYVY->RGB 1080p", lambda: pipe.convert(scaled)))
    # stitch of two 1920x1080 testcards and conference of four participants
    spec = ("stitch:testcard:s=1920x1080:f=240:c=UYVY:p=smpte_bars#testcard:s=1920x1080:f=240:c=RGB:p=noise"
            ";size=2048x1024;fov=170")
    sg, sc = initialize_video_capture(spec), initialize_video_capture(spec, device="cpu")
    (g, _), (c, _) = sg.grab(), sc.grab()
    nd_stitch = byte_diff(g.data, c.data)
    if not g.data.is_cuda or nd_stitch[0]:
        raise RuntimeError(f"stitch: {nd_stitch} bytes differ from the CPU plain path")
    cams = [convert_frame(sg.children[0].frames[0], W1080, Codec.UYVY, Codec.RGB).reshape(H1080, W1080, 3),
            sg.children[1].frames[0].reshape(H1080, W1080, 3)]
    stitch_row = eager_row("stitch blend 2 x 1080p -> 2048x1024", lambda: sg.blend(cams))
    cg, cc = initialize_video_display("conference:1920x1080"), initialize_video_display("conference:1920x1080",
                                                                                         device="cpu")
    for i in range(4):
        f = VideoFrame(cap_cpu.desc, [cap_cpu.frames[i]])
        f.callbacks["ssrc"] = 10 + i
        fg = VideoFrame(cap.desc, [cap.frames[i]])
        fg.callbacks["ssrc"] = 10 + i
        cc.put_frame(f)
        cg.put_frame(fg)
    nd_conf = byte_diff(cg.composite, cc.composite)
    if not cg.composite.is_cuda or nd_conf[0]:
        raise RuntimeError(f"conference: {nd_conf} bytes differ from the CPU plain path")
    return {"phase": "local_loop", "seconds": time.perf_counter() - t_phase, "capture": LOOP_CAPTURE, "capture_filter": LOOP_FILTER,
            "postprocess": LOOP_POSTPROCESS, "frames": LOOP_FRAMES,
            "pipe": {"captured": n, "shown": len(frames), "all_on_card": True, "equal_to_cpu_plain_path": True,
                     "seconds": pipe_s, "frames_per_s": len(frames) / pipe_s},
            "dummy_rgb": {"captured": n_rgb, "shown": disp.frames_shown, "seconds": rgb_s,
                          "frames_per_s": disp.frames_shown / rgb_s, "pace_fps": cap.desc.fps},
            "hand_kernel_launches": hand, "chain_per_frame": row, "chain_parts": parts,
            "stitch": {"cameras": 2, "bytes_differing": nd_stitch[0], "timing": stitch_row},
            "conference": {"participants": 4, "bytes_differing": nd_conf[0]}}


# ---- slice 6: the live session (sender -> RTP/UDP -> receiver) ----

LIVE_CAPTURE = "testcard:s=1920x1080:f=60:c=UYVY"
LIVE_CAPTURE_4K = "testcard:s=3840x2160:f=60:c=UYVY"
LIVE_FRAMES = 120
LIVE_LOSS = 1  # data packets dropped per frame before the receiver, seeded (8 symbols at 1080p)
LIVE_GRACE_S = 2.0  # how long the receiver may trail the sender's last frame
# the JPEG geometries without a mega matrix (codec, subsampling, quality):
# K1's per-plane entry
P2_GEOMS = [("UYVY", "444", 80), ("YUYV", "444", 95), ("RGB", "422", 80), ("RGBA", "422", 90)]
# where the per-plane entry is checked and timed: the four at 1080p, 4K UYVY 4:4:4
PLANE_CASES = [(W1080, H1080, *g) for g in P2_GEOMS] + [(W4K, H4K, "UYVY", "444", 80)]


def kernel_counts():
    """Each hand kernel's launches since the counts were last set to 0."""
    from ultragrid_tpu_torch.ops import fec as fec_ops
    from ultragrid_tpu_torch.ops import jpeg_assemble_cuda, jpeg_cuda, jpeg_decode_cuda

    return {"jpeg_encode": jpeg_cuda.LAUNCHES.count, "jpeg_plane_encode": jpeg_cuda.PLANE_LAUNCHES.count,
            "gf2_parity": fec_ops.LAUNCHES.count, "jpeg_decode": jpeg_decode_cuda.LAUNCHES.count,
            "jpeg_decode_refused": jpeg_decode_cuda.REFUSED.count,
            "jpeg_assemble": jpeg_assemble_cuda.LAUNCHES.count}


def reset_kernel_counts():
    """Set every hand kernel's launch count to 0, after the card's queue."""
    from ultragrid_tpu_torch.ops import fec as fec_ops
    from ultragrid_tpu_torch.ops import jpeg_assemble_cuda, jpeg_cuda, jpeg_decode_cuda

    torch.cuda.synchronize()
    for c in (jpeg_cuda.LAUNCHES, jpeg_cuda.PLANE_LAUNCHES, fec_ops.LAUNCHES, jpeg_decode_cuda.LAUNCHES,
              jpeg_decode_cuda.REFUSED, jpeg_assemble_cuda.LAUNCHES):
        c.reset()


def check_card_decode(what: str, launches: dict, frames_displayed: int):
    """Raise where a JPEG receiver to UYVY decoded fewer frames on the card
    (``jpeg_decode`` launches) than it displayed, or refused one of them (a
    frame then took the C path)."""
    if launches["jpeg_decode"] < frames_displayed or launches["jpeg_decode_refused"]:
        raise RuntimeError(f"{what}: {launches['jpeg_decode']} entropy decodes on the card, "
                           f"{launches['jpeg_decode_refused']} refused, for {frames_displayed} frames displayed")


def udp_rcvbuf_errors() -> int:
    """The kernel's count of UDP datagrams dropped for a full socket receive
    buffer (``RcvbufErrors`` of /proc/net/snmp), or -1 where it is not read."""
    try:
        with open("/proc/net/snmp") as fh:
            rows = [ln.split() for ln in fh if ln.startswith("Udp:")]
        return int(rows[1][rows[0].index("RcvbufErrors")])
    except (OSError, IndexError, ValueError):
        return -1


def free_port_pair(count: int = 2) -> int:
    """A UDP port p with p + 1 .. p + count - 1 free too, from the OS: RTP
    and RTCP, and with ``count=3`` the audio session at p + 2."""
    import socket

    for _ in range(64):
        socks = [socket.socket(socket.AF_INET, socket.SOCK_DGRAM) for _ in range(count)]
        try:
            socks[0].bind(("", 0))
            port = socks[0].getsockname()[1]
            for i, s in enumerate(socks[1:], 1):
                s.bind(("", port + i))
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
        return port
    raise RuntimeError("no free UDP port run")


def drop_data_packets(session, per_frame: int, seed: int, k: int, m: int):
    """Drop ``per_frame`` seeded LDGM data packets of every frame out of the
    sender session's batches, so they never reach the receiver; returns the
    list the dropped counts go to."""
    rng = np.random.default_rng(seed)
    send = session.send_batch
    dropped = []

    def send_batch(ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns=0):
        data_end = np.asarray(data).size * k // (k + m)
        offsets, sizes = np.asarray(offsets), np.asarray(sizes)
        cand = np.flatnonzero(offsets + sizes <= data_end)
        lost = rng.choice(cand, min(per_frame, cand.size), replace=False)
        keep = np.setdiff1d(np.arange(sizes.size), lost)
        dropped.append(int(lost.size))
        return send(ts, pt, hdrs[keep], data, offsets[keep], sizes[keep], m_last, pace_ns)

    session.send_batch = send_batch
    return dropped


def live_run(dev, capture: str, compress: str, fec: str, frames: int, mtu: int = 1500, loss: int = 0,
             keep_every: int = 0, profile_it: bool = False, tap=None, grace_s: float = LIVE_GRACE_S,
             idle_s: float = LIVE_GRACE_S, audio_capture=None, audio_fec: str = "none", audio_loss: int = 0,
             sender_kw=None, on_shown=None, display: str = "dummy", after_shown=None):
    """One session on 127.0.0.1 through the port's entry points: VideoSender
    and VideoReceiver on the card (``--param ldgm-device=device``), a dummy
    display unless ``display`` names another.  The kernels' launch counts are set to 0 just before the
    sender runs and read just after the receiver stops.  ``tap(sender)``
    runs before the sender does.  After the sender's last frame the
    receiver gets ``grace_s`` to catch up, less where it shows nothing new
    for ``idle_s``.  With ``audio_capture`` the session carries audio too
    (``-s``, ``-f A:<audio_fec>``, ``-r wav:<tmp>``), ``audio_loss`` packets
    of every audio frame dropped: every audio frame played must equal the
    one sent under its RTP timestamp.  ``sender_kw`` goes to VideoSender as
    it is; ``on_shown(frame)`` sees every displayed frame before the display
    shows it, ``after_shown(frame, display)`` after.  Returns the
    session's numbers and the frames kept (every ``keep_every``-th shown,
    from the first)."""
    from ultragrid_tpu_torch.pipeline.receiver import VideoReceiver
    from ultragrid_tpu_torch.pipeline.sender import VideoSender
    from ultragrid_tpu_torch.utils import params

    params.set_commandline_param("ldgm-device", "device")
    port = free_port_pair(3)
    wav_dir = tempfile.mkdtemp(prefix="chip_smoke_audio_") if audio_capture else None
    recv = VideoReceiver(display, rx_port=port, device=dev,
                         audio_playback=f"wav:{wav_dir}/played.wav" if audio_capture else None)
    shown, kept, lat, off_card = [], [], [], [0]
    orig = recv.display.put_frame

    def put(frame, blocking=True):
        if frame is not None:
            now90 = int(time.monotonic() * 90000)
            lat.append(((now90 - int(round(frame.timestamp * 90000))) & 0xFFFFFFFF) / 90.0)
            shown.append(time.perf_counter())
            if not frame.data.is_cuda:
                off_card[0] += 1
            if keep_every and (len(shown) - 1) % keep_every == 0:
                kept.append(frame.data.clone())
            if on_shown is not None:
                on_shown(frame)
        orig(frame, blocking)
        if frame is not None and after_shown is not None:
            after_shown(frame, recv.display)

    recv.display.put_frame = put
    rt = threading.Thread(target=recv.run, name="receiver", daemon=True)
    rt.start()
    sender = VideoSender(capture, "127.0.0.1", compress_spec=compress, fec_spec=fec, tx_port=port, mtu=mtu,
                         frame_limit=frames, audio_capture=audio_capture, audio_fec=audio_fec, device=dev,
                         **(sender_kw or {}))
    audio = audio_taps(recv, sender, audio_loss) if audio_capture else None
    dropped = []
    if loss:
        k, m = (int(x) for x in fec.split(":")[1:3])
        dropped = drop_data_packets(sender.session, loss, 17, k, m)
    if tap is not None:
        tap(sender)
    reset_kernel_counts()
    prof = None
    if profile_it:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    sent = sender.run()
    deadline = time.perf_counter() + grace_s
    last, last_t = len(shown), time.perf_counter()
    while len(shown) < sent and time.perf_counter() < deadline:
        time.sleep(0.01)
        if len(shown) != last:
            last, last_t = len(shown), time.perf_counter()
        elif time.perf_counter() - last_t > idle_s:  # the receiver has dropped the rest
            break
    recv.should_exit = True
    rt.join(timeout=30)
    torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    params.reset_params()
    if rt.is_alive():
        raise RuntimeError(f"live session {compress} {fec}: the receiver did not stop")
    launches = kernel_counts()
    wall = (shown[-1] - t0) if shown else float("nan")
    # the first frames also pay the receiver's warm-up (its threads' first
    # decode); the steady p95 leaves out the first 30 shown
    steady = sorted(lat[30:])
    lat.sort()
    st = recv.rx_state
    out = {"capture": capture, "compress": compress, "fec": fec, "mtu": mtu, "frames_sent": sent,
           "frames_displayed": len(shown), "frames_per_s": len(shown) / wall if shown else 0.0,
           "seconds": wall, "frames_off_card": off_card[0], "packets_dropped": int(sum(dropped)),
           "fec_jobs": st.fec_jobs, "fec_jobs_recovered": st.fec_recovered,
           "frames_missing_data": st.frames_missing_data, "launches": launches,
           "latency_ms_p50": lat[len(lat) // 2] if lat else None,
           "latency_ms_p95": lat[min(len(lat) - 1, int(len(lat) * 0.95))] if lat else None,
           "latency_ms_p95_after_first_30": steady[min(len(steady) - 1, int(len(steady) * 0.95))] if steady else None}
    if audio is not None:
        out["audio"] = audio_result(audio, sender, audio_fec)
        shutil.rmtree(wav_dir, ignore_errors=True)
    if prof is not None:
        per = {}
        n_launch = 0
        for evt in prof.key_averages():
            if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
                for kname in ("jpeg_encode_kernel", "gf2_parity_kernel"):
                    if kname in evt.key:
                        per[kname] = per.get(kname, 0) + evt.count
            elif evt.key.startswith(LAUNCH_CALLS):
                n_launch += evt.count
        out["profiler"] = {"device_events_per_frame_sent": {k_: v / sent for k_, v in per.items()},
                           "cuda_launch_calls_per_frame_sent": n_launch / sent}
    return out, kept, sender


def jpeg_ring_matches(dev, kept, ring, what: str):
    """Which ring frame each kept (displayed) frame is the card's JPEG q80
    encode -> decode of; raises where one is no ring frame's.  Returns the
    matched ring indices and the expected frames."""
    from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame

    h, w = ring[0].shape[0], ring[0].shape[1] // 2
    enc = JpegEncoder(w, h)
    dec = JpegDecompress(device=dev)
    desc_j = VideoDesc(w, h, Codec.JPEG, 60.0)
    expect = [dec.decompress(VideoFrame(desc_j, [enc.encode(f)]), Codec.UYVY).data for f in ring]
    matched = set()
    for f in kept:
        hit = [i for i, e in enumerate(expect) if torch.equal(f, e)]
        if not hit:
            raise RuntimeError(f"{what}: a displayed frame is no testcard frame's encode -> decode")
        matched.add(hit[0])
    return matched, expect


def phase_live_session(dev):
    """This slice's main path: the port's sender -> 127.0.0.1 UDP -> the
    port's receiver, on the card.  1080p60 testcard, JPEG q80 + LDGM
    256:26:5 with seeded data-packet loss (the peel runs K2 on the card),
    120 frames: every displayed frame on the card and equal to the card's
    encode -> decode of its testcard frame, which equals the CPU plain path
    (<= 0.1% of bytes off by 1); 1080p60 uncompressed + LDGM; a profiled
    run for launches per frame; --protocol loopback with jpeg:80:0:444 (K1's
    per-plane entry) at 1080p and 4K60; jpeg rate control against its CPU
    quality sequence; a 4K timing row."""
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.modules.video_compress import JpegCompress
    from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.pipeline.loopback import LoopbackRxTx
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame

    t_phase = time.perf_counter()
    out = {"phase": "live_session"}
    jpeg = "jpeg:80"
    main_run, kept, sender = live_run(dev, LIVE_CAPTURE, jpeg, FEC, LIVE_FRAMES, loss=LIVE_LOSS, keep_every=20)
    out["jpeg_ldgm_1080p"] = main_run
    if main_run["frames_displayed"] < LIVE_FRAMES // 2 or main_run["frames_off_card"]:
        raise RuntimeError(f"live session 1080p jpeg: {main_run}")
    if min(main_run["launches"]["jpeg_encode"], main_run["launches"]["gf2_parity"]) < 1:
        raise RuntimeError(f"live session 1080p jpeg skipped a kernel: {main_run['launches']}")
    check_card_decode("live session 1080p jpeg", main_run["launches"], main_run["frames_displayed"])
    if main_run["packets_dropped"] < 1 or main_run["fec_jobs_recovered"] < 1:
        raise RuntimeError("live session 1080p jpeg: no loss was recovered by the peel")
    # the expected frames: the card's encode -> decode of each testcard ring
    # frame; each kept frame must be one of them, and they must equal the
    # CPU plain path
    matched, expect = jpeg_ring_matches(dev, kept, sender.capture.frames, "live session 1080p jpeg")
    desc_j = VideoDesc(W1080, H1080, Codec.JPEG, 60.0)
    ring_cpu = initialize_video_capture(LIVE_CAPTURE, device="cpu").frames
    dec_cpu = JpegDecompress(device="cpu")
    worst = (0, 0)
    for i in sorted(matched)[:2]:
        want = dec_cpu.decompress(VideoFrame(desc_j, [JpegEncoder(W1080, H1080).encode(ring_cpu[i], device="cpu")]),
                                  Codec.UYVY).data
        nd, err = byte_diff(expect[i], want)
        worst = max(worst, (nd, err))
        if err > 1 or nd > MAX_DIFF_BYTE_SHARE * want.numel():
            raise RuntimeError(f"live session: ring frame {i} differs from the CPU plain path ({nd} bytes, max {err})")
    out["jpeg_ldgm_1080p"].update(displayed_frames_checked=len(kept), ring_frames_matched=len(matched),
                                  bytes_differing_from_cpu_plain=worst[0], max_abs_err_vs_cpu_plain=worst[1])
    # launches per frame from the profiler, on a shorter profiled session
    prof_run, _, _ = live_run(dev, LIVE_CAPTURE, jpeg, FEC, 30, loss=LIVE_LOSS, profile_it=True)
    out["jpeg_ldgm_1080p_profiled"] = prof_run
    # 1080p60 uncompressed with LDGM: displayed frames are the ring frames
    # (a frame that lost a packet on the way is shown with the hole
    # zero-filled, as the reference does; every whole one is a ring frame)
    raw_run, kept_raw, sender_raw = live_run(dev, LIVE_CAPTURE, "none", FEC, LIVE_FRAMES, mtu=9000, keep_every=20)
    whole = sum(any(torch.equal(f, r) for r in sender_raw.capture.frames) for f in kept_raw)
    if (raw_run["frames_displayed"] < 1 or raw_run["frames_off_card"] or whole < 1
            or len(kept_raw) - whole > raw_run["frames_missing_data"]):
        raise RuntimeError(f"live session 1080p uncompressed: {raw_run}, {whole} of {len(kept_raw)} kept frames whole")
    raw_run.update(displayed_frames_checked=len(kept_raw), displayed_frames_whole=whole)
    out["none_ldgm_1080p"] = raw_run
    # --protocol loopback with jpeg at 4:4:4: K1's per-plane entry, 1080p60
    # and a 4K60 camera
    for key, capture, nframes in (("loopback_jpeg_444", LIVE_CAPTURE, 30),
                                  ("loopback_jpeg_444_4k60", LIVE_CAPTURE_4K, 60)):
        shown = []
        lb = LoopbackRxTx(capture, "dummy", compress_spec="jpeg:80:0:444", frame_limit=nframes, device=dev)
        orig = lb.display.put_frame
        lb.display.put_frame = lambda f, blocking=True, orig=orig: (shown.append(f is None or f.data.is_cuda),
                                                                    orig(f, blocking))
        reset_kernel_counts()
        t0 = time.perf_counter()
        n_lb = lb.run()
        torch.cuda.synchronize()
        lb_s = time.perf_counter() - t0
        lb_launches = kernel_counts()
        if n_lb != nframes or not all(shown) or lb_launches["jpeg_plane_encode"] < nframes:
            raise RuntimeError(f"loopback jpeg:80:0:444 {capture}: {n_lb} of {nframes} shown, launches {lb_launches}")
        out[key] = {"capture": capture, "frames": nframes, "frames_shown": n_lb, "frames_per_s": n_lb / lb_s,
                    "seconds": lb_s, "all_on_card": True, "launches": lb_launches}
    out.update(h264_live_rows(dev))
    out.update(codec_live_rows(dev))
    # jpeg rate control on the card against the CPU's quality sequence
    w_r, h_r = 640, 360
    frames_r = [torch.as_tensor(content(h_r, 2 * w_r, 60 + i)) for i in range(24)]
    desc_r = VideoDesc(w_r, h_r, Codec.UYVY, 30.0)
    size80 = JpegEncoder(w_r, h_r).encode(frames_r[0], device="cpu").size
    rate = int(size80 * 8 * 30 * 0.7)
    qs = {}
    files = {}
    for where in ("card", "cpu"):
        c = JpegCompress(f"80:rate={rate}", device=dev if where == "card" else "cpu")
        qs[where], files[where] = [], []
        for f in frames_r:
            files[where].append(c.compress(VideoFrame(desc_r, [f.to(dev) if where == "card" else f])).data)
            qs[where].append(c._rc.value)
    same_files = sum(np.array_equal(a, b) for a, b in zip(files["card"], files["cpu"]))
    if qs["card"] != qs["cpu"] or len(set(qs["cpu"])) < 2:
        raise RuntimeError(f"jpeg rate control: card {qs['card']} vs CPU {qs['cpu']}")
    out["jpeg_rate_control"] = {"geometry": f"{w_r}x{h_r} UYVY", "rate_bps": rate, "frames": len(frames_r),
                                "qualities": qs["card"], "same_as_cpu": True,
                                "files_equal_to_cpu": int(same_files)}
    # the 4K timing row
    out["jpeg_ldgm_4k"] = live_run(dev, LIVE_CAPTURE_4K, jpeg, FEC, LIVE_FRAMES)[0]
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- slice 7: the H.264 codec (no hand kernel in the encoders: the
# reference's device stages are XLA graphs; K2 runs in the session's peel) ----

LIVE_H264 = "h264:mode=inter:accel=device:gop=30"
# LDGM 256:26:5 recovers one lost packet only while the packet holds few of
# the 256 data symbols.  The testcard's 1080p IDR is about 17.5 KB: 72-byte
# symbols, 20 to a packet at the session's default MTU of 1500, where the
# loss of any one of its packets is beyond the code and the GOP is lost
# (ROADMAP F6, an open fault; the 40-frame row at 1500 asserts that reading,
# so that a change shows).  MTU 600 is no deployment's value: it is where a
# packet holds few enough symbols (7 of the IDR's) for every packet's loss
# to be recoverable, and ``ldgm_packet_recovery`` asserts that for the
# session's own frames before the session is taken as the H.264 row.
LIVE_H264_MTU = 600
LIVE_H264_MTU1500_FRAMES = 40


def symbols_per_packet(ps: int, mtu: int) -> int:
    """Whole LDGM symbols of ``ps`` bytes in one packet at ``mtu``
    (transmit.py's get_video_pkt_len)."""
    from ultragrid_tpu_torch.net import rtp_types as rt
    from ultragrid_tpu_torch.net.transmit import IPV4_HDR_LEN, UDP_HDR_LEN

    return max(1, (mtu - (IPV4_HDR_LEN + UDP_HDR_LEN + rt.RTP_HDR_LEN + rt.FEC_PAYLOAD_HDR_LEN)) // ps)


def ldgm_packet_recovery(frame: np.ndarray, mtu: int):
    """For one access unit under LDGM 256:26:5 at ``mtu``: (symbol bytes,
    symbols a packet holds, data packets whose loss alone the host peel
    recovers, data packets)."""
    from ultragrid_tpu_torch.ops.fec import fec_from_spec

    sess = fec_from_spec(FEC, frame.size, mtu)
    buf, desc = sess.encode(frame)
    ps = desc.symbol_size
    per = symbols_per_packet(ps, mtu)
    sym = buf.reshape(-1, ps)
    ok = n = 0
    for start in range(0, sess.k, per):
        present = np.ones(sym.shape[0], bool)
        present[start:start + per] = False
        ok += sess.decode(np.where(present[:, None], sym, 0), present) is not None
        n += 1
    return {"symbol_bytes": ps, "symbols_per_packet": per, "packets_recoverable": ok, "data_packets": n}


def k2_peel_rows(dev, items, mtu: int, seed: int):
    """K2 at a session's container shapes: for each (what, frame bytes),
    LDGM 256:26:5 with the symbols of one seeded data packet at ``mtu``
    lost; K2 with and without the staircase on that block against its plain
    version, and the peel on the card giving the frame back."""
    from ultragrid_tpu_torch.ops.fec import fec_from_spec

    rng = np.random.default_rng(seed)
    err, cases = 0, []
    for what, au in items:
        sess = fec_from_spec(FEC, au.size, mtu)
        buf, desc = sess.encode(au)
        ps = desc.symbol_size
        per = symbols_per_packet(ps, mtu)
        start = per * int(rng.integers(0, -(-sess.k // per)))
        present = np.ones(sess.k + sess.m, bool)
        present[start:min(start + per, sess.k)] = False
        sym = np.where(present[:, None], buf.reshape(-1, ps), 0).astype(np.uint8)
        block = torch.as_tensor(sym).to(dev)
        e, case = k2_peel_case(sess, block, f"{what} {au.size} B, 256:26:5 ps={ps}, "
                                            f"{int((~present).sum())} symbols of one packet at MTU {mtu} lost")
        got = sess.decode_device(block, present)
        if got is None or not np.array_equal(np.asarray(got).reshape(-1), au):
            raise RuntimeError(f"{what}: the peel on the card did not give the frame back")
        err = max(err, e)
        cases.append({**case, "recovered_on_card": True})
    return {"max_abs_err": err, "cases": cases}


def h264_k2_peel(dev, aus, mtu: int):
    """K2 at the H.264 session's container shapes: its first IDR and its
    median P frame (:func:`k2_peel_rows`)."""
    p_frames = sorted((a for i, a in enumerate(aus) if i % 30), key=len)
    return k2_peel_rows(dev, (("h264 IDR", aus[0]), ("h264 median P", p_frames[len(p_frames) // 2])), mtu, 29)


H264_QP = 26
H264_FRAMES = 12
H264_GOP = 6  # one IDR mid-run


def h264_sequence(n: int, seed: int = 70):
    """n 1080p UYVY frames of a seeded picture (two waves and sensor-like
    noise, limited range) panned 2 samples right and 1 down a frame."""
    rng = np.random.default_rng(seed)
    hh, ww = H1080 + n, 2 * W1080 + 4 * n
    yy, xx = np.mgrid[0:hh, 0:ww].astype(np.float32)
    base = 120 + 50 * np.sin(xx * 0.011 + yy * 0.017) + 30 * np.sin(xx * 0.003 - yy * 0.02)
    base = (base + rng.normal(0, 3, (hh, ww))).clip(16, 235).astype(np.uint8)
    return [np.ascontiguousarray(base[i:i + H1080, 4 * i:4 * i + 2 * W1080]) for i in range(n)]


def all_skip_au(frame_num: int, nmb: int) -> bytes:
    """The P access unit whose every macroblock is P_Skip: the slice header
    and one skip run."""
    from ultragrid_tpu_torch.ops import h264 as h264_ops

    bw = h264_ops.BitWriter()
    h264_ops._p_slice_header(bw, 0, frame_num)
    bw.ue(nmb)
    bw.rbsp_trailing()
    return h264_ops.nal(3, 1, bw.rbsp())


def phase_h264(dev):
    """The own H.264 encoders at 1920x1080 on the card against the same
    modules on the CPU (byte-equal access units), every decoded frame
    against the encoder's reference picture, the all-tie case, and the
    timing rows: IDR and P frames per frame (launches, device and host ms,
    idle share, the C assembly's share), H264Compress i16 and inter as a
    user names them (on the card by default), and the CABAC transcode."""
    from ultragrid_tpu_torch.modules.video_compress import H264Compress, SessionTranscoder
    from ultragrid_tpu_torch.ops import h264_device as hdev
    from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice, Intra16EncoderDevice
    from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame

    t_phase = time.perf_counter()
    out = {"phase": "h264", "geometry": f"{W1080}x{H1080} UYVY", "qp": H264_QP}
    frames = h264_sequence(H264_FRAMES)
    frames_d = [torch.as_tensor(f).to(dev) for f in frames]
    nmb = ((W1080 + 15) // 16) * ((H1080 + 15) // 16)

    def planes_equal(got, ref_planes):
        return all(np.array_equal(g, r.cpu().numpy()[:g.shape[0], :g.shape[1]]) for g, r in zip(got, ref_planes))

    # intra: the card against the CPU, and its decode
    card = Intra16EncoderDevice(W1080, H1080, qp=H264_QP, device=dev)
    idr = card.encode_uyvy(frames_d[0])
    if idr != Intra16EncoderDevice(W1080, H1080, qp=H264_QP, device="cpu").encode_uyvy(frames[0]):
        raise RuntimeError("h264 intra: the card's access unit differs from the CPU's")
    y, _, _ = FastStreamDecoder().decode_au(idr)
    if y.shape != (H1080, W1080):
        raise RuntimeError(f"h264 intra: decoded {y.shape}")
    out["intra"] = {"bytes": len(idr), "wwords": card.wwords, "equal_to_cpu": True}
    # P frames: two configurations over the moving sequence, IDRs at 0 and 6
    card_aus = {}
    for label, kw in (("search8_half", {"search": 8}), ("search4_quarter", {"search": 4, "subpel": "quarter"})):
        card = InterEncoderDevice(W1080, H1080, qp=H264_QP, gop=H264_GOP, device=dev, **kw)
        cpu = InterEncoderDevice(W1080, H1080, qp=H264_QP, gop=H264_GOP, device="cpu", **kw)
        dec = FastStreamDecoder()
        sizes, aus_l = [], []
        for i, (f, fd) in enumerate(zip(frames, frames_d)):
            au = card.encode_uyvy(fd)
            aus_l.append(au)
            if au != cpu.encode_uyvy(f):
                raise RuntimeError(f"h264 {label}: frame {i}'s access unit differs from the CPU's")
            if not all(p.is_cuda for p in card.ref):
                raise RuntimeError(f"h264 {label}: the reference picture left the card")
            if not planes_equal(dec.decode_au(au), card.ref):
                raise RuntimeError(f"h264 {label}: frame {i} decodes to another picture than the encoder's")
            sizes.append(len(au))
        card_aus[label] = aus_l
        out[label] = {"frames": len(sizes), "gop": H264_GOP, "au_bytes": sizes, "wwords": card.wwords,
                      "equal_to_cpu": True, "decoded_equal_to_ref": True}
    # every candidate ties on flat content: zero vectors, all P_Skip, on
    # the card as on the CPU (both start from the flat picture mid-GOP)
    flat = np.full((H1080, 2 * W1080), 128, np.uint8)
    flat[:, 1::2] = 90
    ties = []
    for where in (dev, "cpu"):
        e = InterEncoderDevice(W1080, H1080, qp=H264_QP, search=8, device=where)
        e.ref = hdev.uyvy_to_planes(torch.as_tensor(flat).to(where), W1080, H1080)
        e._frame_idx = e._frame_num = 1
        ties.append([e.encode_uyvy(torch.as_tensor(flat).to(where)) for _ in range(2)])
    if ties[0] != ties[1] or ties[0] != [all_skip_au(1, nmb), all_skip_au(2, nmb)]:
        raise RuntimeError("h264: flat content did not give all-skip P frames on the card")
    out["ties"] = {"frames": 2, "all_skip": True, "au_bytes": [len(a) for a in ties[0]]}

    # ---- timing rows ----
    rows = []
    planes = hdev.uyvy_to_planes(frames_d[1], W1080, H1080)
    intra = Intra16EncoderDevice(W1080, H1080, qp=H264_QP, device=dev)
    intra.encode_uyvy(frames_d[1])  # settles the window width
    graph = intra._fn()
    rows.append(eager_row("h264 IDR graph 1080p qp26 (device part of Intra16EncoderDevice)",
                          lambda: graph(*planes), runs=10))
    words, bits, _ = graph(*planes)
    wn = np.concatenate([hdev._bit_window(intra._hdr_val, intra._hdr_bits, words.shape[1]),
                         hdev._words_to_host(words)])
    bn = np.concatenate([[intra._hdr_bits], bits.cpu().numpy()])
    total = host_ms(lambda: intra.encode_uyvy(frames_d[1]), runs=10)
    asm = host_ms(lambda: hdev._assemble(wn, bn), runs=10)
    rows[-1].update(frame_ms=total, assembly_ms=asm, assembly_share=asm / total, wwords=intra.wwords)
    for label, kw in (("search 8 half-pel", {"search": 8}), ("search 4 quarter-pel", {"search": 4, "subpel": "quarter"})):
        enc = InterEncoderDevice(W1080, H1080, qp=H264_QP, gop=1000, device=dev, **kw)
        enc.encode_uyvy(frames_d[0])
        idr_ms = host_ms(lambda: enc._encode_idr(*hdev.uyvy_to_planes(frames_d[0], W1080, H1080)), runs=5)
        enc.encode_uyvy(frames_d[1])  # settles the window width
        ref0 = enc.ref
        cur = hdev.uyvy_to_planes(frames_d[2], W1080, H1080)
        graph_p = enc._fn()
        rows.append(eager_row(f"h264 P graph 1080p qp26 {label} (device part of InterEncoderDevice)",
                              lambda: graph_p(*cur, *ref0), runs=10))
        words, bits = graph_p(*cur, *ref0)[:2]
        wn_p, bn_p = hdev._words_to_host(words), bits.cpu().numpy()

        def p_frame():
            enc._encode_p(*cur)
            enc.ref = ref0

        total = host_ms(p_frame, runs=10)
        asm = host_ms(lambda: enc._assemble(wn_p, bn_p), runs=10)
        rows[-1].update(frame_ms=total, assembly_ms=asm, assembly_share=asm / total, wwords=enc.wwords,
                        idr_frame_ms=idr_ms, p_bytes=len(enc._assemble(wn_p, bn_p)))
    # the compress modules as a user names them (-c h264, -c h264:mode=inter:
    # gop=6): the device encoders on the card by default, the 12-frame
    # sequence per frame, the access units those of the encoders above
    desc = VideoDesc(W1080, H1080, Codec.UYVY, 60.0)
    for spec, cls, want in (("", Intra16EncoderDevice, [idr]),
                            (f"mode=inter:gop={H264_GOP}", InterEncoderDevice, card_aus["search8_half"])):
        comp = H264Compress(spec, device=dev)
        per, got_aus = [], []
        for fd in frames_d:
            t0 = time.perf_counter()
            got = comp.compress(VideoFrame(desc, [fd]))
            per.append((time.perf_counter() - t0) * 1e3)
            if got is None or got.desc.color_spec != Codec.H264:
                raise RuntimeError(f"H264Compress {spec!r}: no access unit")
            got_aus.append(got.data.tobytes())
        if not isinstance(comp._enc, cls) or comp.accel != "device":
            raise RuntimeError(f"-c h264:{spec}: built {type(comp._enc).__name__}, not the card's {cls.__name__}")
        if got_aus[:len(want)] != list(want):
            raise RuntimeError(f"-c h264:{spec}: its access units differ from {cls.__name__}'s on the card")
        comp.done()
        rows.append({"what": f"H264Compress {spec!r} (accel: {comp.accel}) 1080p, {len(per)} frames",
                     "ms_per_frame": per, "mean_ms": sum(per) / len(per), "equal_to_encoder": len(want)})
    # the CABAC transcode of an IDR and a P access unit
    cabac = SessionTranscoder()
    try:
        enc = InterEncoderDevice(W1080, H1080, qp=H264_QP, gop=1000, device=dev)
        aus = [enc.encode_uyvy(fd) for fd in frames_d[:2]]
        cabac.transcode_au(aus[0])
        rows.append({"what": "entropy=cabac transcode 1080p (host C)", "idr_bytes": len(aus[0]),
                     "idr_ms": host_ms(lambda: SessionTranscoder().transcode_au(aus[0]), runs=5),
                     "p_bytes": len(aus[1]), "p_ms": host_ms(lambda: cabac.transcode_au(aus[1]), runs=10)})
    finally:
        cabac.close()
    out["timing"] = {"card": nvidia_smi_line(), "rows": rows}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def h264_live_rows(dev):
    """The H.264 live session: 1080p60 testcard, h264 inter on the card, LDGM
    256:26:5 at MTU 600 with one seeded data packet dropped per frame, the
    peel on the card; every displayed frame's luma equal to the sender's
    reference picture of that frame; K2 at the session's IDR and P container
    shapes against its plain version.  The same at MTU 1500 for 40 frames,
    held to ROADMAP F6's reading: nothing shown, every IDR lost.  Then
    --protocol loopback with h264 i16 (30 frames) and inter with CABAC (10
    frames)."""
    from ultragrid_tpu_torch.ops import fec as fec_ops
    from ultragrid_tpu_torch.pipeline.loopback import LoopbackRxTx

    recon, aus = [], []

    def tap(sender):
        impl = sender.compress.impl
        compress = impl.compress

        def compress_and_keep(frame):
            got = compress(frame)
            recon.append(impl._enc.ref[0][:H1080, :W1080].clone())
            aus.append(np.asarray(got.data))
            return got

        impl.compress = compress_and_keep

    run, kept, _ = live_run(dev, LIVE_CAPTURE, LIVE_H264, FEC, LIVE_FRAMES, mtu=LIVE_H264_MTU, loss=LIVE_LOSS,
                            keep_every=1, tap=tap)
    if run["frames_sent"] != LIVE_FRAMES or run["frames_displayed"] != LIVE_FRAMES or run["frames_off_card"]:
        raise RuntimeError(f"live session 1080p h264: {run}")
    if run["launches"]["gf2_parity"] < 1 or run["packets_dropped"] < 1 or run["frames_missing_data"]:
        raise RuntimeError(f"live session 1080p h264: the peel did not recover every frame: {run}")
    same = sum(torch.equal(f[:, 1::2], r) for f, r in zip(kept, recon))
    if len(recon) != LIVE_FRAMES or same != LIVE_FRAMES:
        raise RuntimeError(f"live session 1080p h264: {same} of {len(recon)} displayed frames equal the sender's")
    sizes = [a.size for a in aus]
    p_aus = sorted((a for i, a in enumerate(aus) if i % 30), key=len)
    recovery = {f"{what} at MTU {mtu}": ldgm_packet_recovery(au, mtu)
                for what, au in (("IDR", aus[0]), ("median P", p_aus[len(p_aus) // 2]))
                for mtu in (1500, LIVE_H264_MTU)}
    for what in ("IDR", "median P"):
        r = recovery[f"{what} at MTU {LIVE_H264_MTU}"]
        if r["packets_recoverable"] != r["data_packets"]:
            raise RuntimeError(f"h264 at MTU {LIVE_H264_MTU}: not every lost packet of the {what} is recoverable: {r}")
    if recovery["IDR at MTU 1500"]["packets_recoverable"]:
        raise RuntimeError(f"h264 at MTU 1500: ROADMAP F6 reads no lost IDR packet recoverable; now "
                           f"{recovery['IDR at MTU 1500']}: update F6 and this check")
    run.update(displayed_frames_checked=len(kept), luma_equal_to_sender_ref=same,
               k2_launches_per_frame=run["launches"]["gf2_parity"] / LIVE_FRAMES,
               au_bytes_idr=sizes[::30], au_bytes_p_min_median_max=[p_aus[0].size, p_aus[len(p_aus) // 2].size,
                                                                   p_aus[-1].size],
               ldgm_packet_recovery=recovery)
    k2_h264 = h264_k2_peel(dev, aus, LIVE_H264_MTU)
    out = {"h264_inter_ldgm_1080p": run, "h264_k2_peel": k2_h264}
    del kept, recon, aus
    # ROADMAP F6: at the default MTU every IDR is lost, so nothing is shown
    run1500 = live_run(dev, LIVE_CAPTURE, LIVE_H264, FEC, LIVE_H264_MTU1500_FRAMES, loss=LIVE_LOSS)[0]
    if run1500["frames_sent"] != LIVE_H264_MTU1500_FRAMES or run1500["frames_displayed"]:
        raise RuntimeError(f"live session 1080p h264 at MTU 1500: ROADMAP F6 reads 0 shown (every IDR lost); "
                           f"now {run1500}: update F6 and this check")
    out["h264_inter_ldgm_1080p_mtu1500"] = run1500
    for spec, n in (("h264:accel=device", 30), ("h264:mode=inter:accel=device:entropy=cabac", 10)):
        shown = []
        lb = LoopbackRxTx(LIVE_CAPTURE, "dummy", compress_spec=spec, frame_limit=n, device=dev)
        orig = lb.display.put_frame
        lb.display.put_frame = lambda f, blocking=True, orig=orig: (
            shown.append(f is None or f.data.is_cuda), orig(f, blocking))
        torch.cuda.synchronize()
        fec_ops.LAUNCHES.reset()
        t0 = time.perf_counter()
        got = lb.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if got != n or not all(shown):
            raise RuntimeError(f"loopback {spec}: {got} of {n} shown, all on the card: {all(shown)}")
        out[f"loopback_{spec}"] = {"frames_shown": got, "frames_per_s": got / secs, "all_on_card": True}
    return out


# ---- the wavelet and intra codecs (no hand kernel on their device
# stages: the reference's are jnp ops; K2 runs in the sessions' peel) ----

CODEC_SPECS = ["jpegxs", "jpegxs:100", "cineform", "cineform:100", "openapv", "openapv:0", "j2k:90"]
CODEC_LOSSLESS = ("jpegxs:100", "cineform:100")
# the streams of the reference tests' fixed inputs (tests/test_jpegxs.py:88,
# tests/test_cineform.py:92, tests/test_apv.py:138, tests/test_j2k.py:132)
CODEC_GOLDEN = {
    "jpegxs": "20621eebdd37a4bb2b2d684f181ea0440a63541f3fd0d5412e8db1c3b1cc1d55",
    "cineform": "6ecbfc71735be76a97dd97bb9d97aaf248c07f18cea7dedd63eba13d135b459d",
    "openapv": "9e62674295f42d8f4b784b1af9331b7301be2e40fca22141e3db08bb1391f8c0",
    "j2k": "9be527f808147fff25561db1aec492f000c36eb5f84c19af10f63c538b165350",
}
# the live rows: (spec, frames sent); the host entropy stages take tenths of
# a second a 1080p frame, so few frames
CODEC_LIVE = (("jpegxs", 24), ("openapv", 40))
CODEC_LOOPBACK = (("cineform", 4), ("cineform:100", 2), ("j2k:90", 4))
CODEC_GRACE_S = 20.0  # the receiver's host decode trails the sender by seconds
CODEC_IDLE_S = 5.0  # ... and drops frames it cannot keep up with


def golden_streams(dev):
    """{codec: (stream, decode ok)} of the reference tests' fixed inputs, the
    device stages on ``dev``."""
    import hashlib

    from ultragrid_tpu_torch.ops import apv, cineform, j2k, jpegxs

    plane = torch.as_tensor((np.arange(32 * 48).reshape(32, 48) % 251).astype(np.int32)).to(dev)
    apv_plane = torch.as_tensor((np.arange(48 * 64).reshape(48, 64) * 13 % 1021).astype(np.int32)).to(dev)
    cases = {"jpegxs": (jpegxs.JpegXsCodec(3, 1, 90, device=dev), plane, 4),
             "cineform": (cineform.CineformCodec(3, 90, device=dev), plane, 16),
             "openapv": (apv.ApvCodec(qp=18, device=dev), apv_plane, 16)}
    out = {}
    for name, (codec, p, bound) in cases.items():
        stream = codec.encode_planes([p])
        back = codec.decode_planes(stream)[0]
        if back.device != p.device or int((back - p).abs().max()) > bound:
            raise RuntimeError(f"golden {name}: the decode on the card is off its bound {bound}")
        out[name] = hashlib.sha256(stream).hexdigest()
    gray = plane.cpu().numpy().astype(np.uint8)
    cs = j2k.encode_gray(gray, levels=3, quality=100)
    if not np.array_equal(j2k.J2KDecoder().decode(cs)[0], gray):
        raise RuntimeError("golden j2k: the own decoder does not give the plane back")
    out["j2k"] = hashlib.sha256(cs).hexdigest()
    for name, digest in out.items():
        if digest != CODEC_GOLDEN[name]:
            raise RuntimeError(f"golden {name}: {digest} is not the reference's {CODEC_GOLDEN[name]}")
    return out


def codec_stages(spec, comp, src_dev, stream, dev):
    """(the encoder's device stage, the decoder's device stage) of ``spec``
    on a 1080p UYVY frame on the card, each a call that ends in the one copy
    per plane (down, for the encoder; the decoder's starts with one up): the
    split, the DWT or DCT and the copy down; the upload, the inverse and the
    interleave."""
    from ultragrid_tpu_torch.modules.video_compress import uyvy_planes
    from ultragrid_tpu_torch.modules.video_decompress import cfhd_uyvy, uyvy_interleave
    from ultragrid_tpu_torch.ops import pixfmt
    from ultragrid_tpu_torch.ops.cfhd_bitstream import cfhd_decode
    from ultragrid_tpu_torch.types import Codec

    if spec.startswith("jpegxs") or spec == "cineform:100":
        codec = comp.codec
        bands = [codec.analyse(p) for p in uyvy_planes(src_dev, W1080)]
        return (lambda: [codec.analyse(p) for p in uyvy_planes(src_dev, W1080)],
                lambda: uyvy_interleave(*[codec.synthesise(b) for b in bands]))
    if spec == "cineform":
        planes = cfhd_decode(bytes(stream), W1080, H1080)
        return lambda: src_dev[:, : 2 * W1080].cpu(), lambda: cfhd_uyvy(planes, dev)
    if spec.startswith("openapv"):
        codec = comp.codec
        levels = [codec.analyse(p, ci, 2 if ci else 1) for ci, p in enumerate(uyvy_planes(src_dev, W1080, 2))]
        return (lambda: [codec.analyse(p, ci, 2 if ci else 1) for ci, p in enumerate(uyvy_planes(src_dev, W1080, 2))],
                lambda: uyvy_interleave(*[(codec.synthesise(lv, codec.qp, 10)[:H1080] + 2) >> 2 for lv in levels]))
    rgb = pixfmt.convert_frame(src_dev, W1080, Codec.UYVY, Codec.RGB).cpu().numpy()
    return (lambda: pixfmt.convert_frame(src_dev, W1080, Codec.UYVY, Codec.RGB).cpu(),
            lambda: torch.from_numpy(rgb).to(dev))


def copies_and_kernels(ks):
    """(launches, device ms, DtoH copies, HtoD copies) per call from
    device_kernels' result; launches and device ms are the kernels'."""
    kern = {n: v for n, v in ks.items() if not n.lower().startswith(("memcpy", "memset"))}
    return (sum(c for c, _ in kern.values()), sum(ms for _, ms in kern.values()),
            sum(c for n, (c, _) in ks.items() if "dtoh" in n.lower()),
            sum(c for n, (c, _) in ks.items() if "htod" in n.lower()))


def phase_codecs(dev):
    """The wavelet and intra codecs at 1920x1080 as a user names them
    (``compress_init`` / ``decompress_init``): on the testcard's bars and a
    seeded content frame, the stream of the module on the card is the CPU
    module's byte for byte, the decode on the card stays there and is the
    CPU's (for the lossless specs on the content frame: the input itself),
    the lossless specs give the input back, and the reference tests' golden
    digests come out of the card's device stages.  Timing rows
    on the bars: encode and decode ms a frame by the host clock, the
    profiler's launches, device ms and copies a frame, the device stage alone
    (split, DWT or DCT, interleave, with its copy) and the host entropy
    stage's share."""
    from ultragrid_tpu_torch.modules.video_compress import compress_init
    from ultragrid_tpu_torch.modules.video_decompress import decompress_init
    from ultragrid_tpu_torch.ops import pixfmt
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
    from ultragrid_tpu_torch.utils.pattern import generate_pattern

    t_phase = time.perf_counter()
    out = {"phase": "codecs", "geometry": f"{W1080}x{H1080} UYVY"}
    desc = VideoDesc(W1080, H1080, Codec.UYVY, 60.0)
    frames = {"bars": generate_pattern(W1080, H1080, Codec.UYVY, "bars", device="cpu").contiguous(),
              "content": torch.as_tensor(content(H1080, 2 * W1080, 81))}
    rows = []
    for spec in CODEC_SPECS:
        comp, comp_cpu = compress_init(spec, device=dev), compress_init(spec, device="cpu")
        row = {"spec": spec}
        for label, src in frames.items():
            src_dev = src.to(dev)
            got = comp.compress(VideoFrame(desc, [src_dev]))
            want = comp_cpu.compress(VideoFrame(desc, [src]))
            if bytes(np.asarray(got.data)) != bytes(np.asarray(want.data)):
                raise RuntimeError(f"codec {spec} {label}: the stream on the card differs from the CPU's")
            dec, out_codec = decompress_init(got.desc.color_spec, [Codec.UYVY, Codec.RGB], device=dev)
            shown = dec.decompress(got, out_codec).data
            if shown.device.type != torch.device(dev).type:
                raise RuntimeError(f"codec {spec} {label}: the decode left the card")
            if spec in CODEC_LOSSLESS and not torch.equal(shown.cpu(), src):
                raise RuntimeError(f"codec {spec} {label}: lossless, but the decode on the card is not the input")
            if spec in CODEC_LOSSLESS and label == "content":
                shown_cpu = src  # the input itself: the CPU's UCF1 decode of it takes tens of seconds
            else:
                dec_cpu, _ = decompress_init(got.desc.color_spec, [Codec.UYVY, Codec.RGB], device="cpu")
                shown_cpu = dec_cpu.decompress(want, out_codec).data
                if not torch.equal(shown.cpu(), shown_cpu):
                    raise RuntimeError(f"codec {spec} {label}: the decode on the card differs from the CPU's")
            ref = src if out_codec == Codec.UYVY else pixfmt.convert_frame(src, W1080, Codec.UYVY, Codec.RGB,
                                                                           device="cpu")
            row[label] = {"bytes": int(np.asarray(got.data).size), "out": out_codec.name,
                          "psnr_db": psnr(shown_cpu, ref), "card_equals_cpu": True}
        # timing on the bars, the module warmed above
        src_dev = frames["bars"].to(dev)
        frame = VideoFrame(desc, [src_dev])
        stream = comp.compress(frame)
        runs = 1  # one timed call a row: the host entropy takes 0.04-1.3 s a 1080p frame
        enc_stage, dec_stage = codec_stages(spec, comp, src_dev, np.asarray(stream.data), dev)
        for what, fn, stage in (("encode", lambda: comp.compress(frame), enc_stage),
                                ("decode", lambda: dec.decompress(stream, out_codec), dec_stage)):
            ms = host_ms(lambda: (fn(), torch.cuda.synchronize()), runs, warmup=False)
            stage_ms = host_ms(lambda: (stage(), torch.cuda.synchronize()), runs)
            launches, dev_ms, d2h, h2d = copies_and_kernels(device_kernels(fn, runs=runs, warmup=False))
            s_launches, s_dev_ms, _, _ = copies_and_kernels(device_kernels(stage, runs=runs, warmup=False))
            row[what] = {"ms": ms, "launches": launches, "device_ms": dev_ms, "copies_dtoh": d2h,
                         "copies_htod": h2d, "device_stage_ms": stage_ms, "device_stage_launches": s_launches,
                         "device_stage_device_ms": s_dev_ms, "host_entropy_ms": ms - stage_ms,
                         "idle_share": max(0.0, 1 - dev_ms / ms)}
        planes = 1 if spec.startswith(("cineform", "j2k")) and spec != "cineform:100" else 3
        if row["encode"]["copies_dtoh"] > planes or row["decode"]["copies_htod"] > planes:
            raise RuntimeError(f"codec {spec}: more than one copy a plane: {row['encode']}, {row['decode']}")
        rows.append(row)
    out["rows"] = rows
    out["golden"] = golden_streams(dev)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def codec_live_rows(dev):
    """The wavelet and intra codecs in the live session at 1080p60 testcard:
    ``-c jpegxs`` and ``-c openapv``, each with LDGM 256:26:5 at the default
    MTU of 1500 and one seeded data packet dropped per frame, the peel on
    the card.  Every displayed frame, in order, is the CPU decode of a
    stream the sender sent; every packet's loss of the first stream is
    recoverable at 1500 (``ldgm_packet_recovery``; a row where it is not
    would read as ROADMAP F6 does); K2 at the session's container shape
    against its plain version.  Then ``--protocol loopback`` rows for
    cineform, cineform:100 and j2k:90: every frame shown, on the card, equal
    to the CPU decode of the card's stream."""
    from ultragrid_tpu_torch.modules.video_decompress import decompress_init
    from ultragrid_tpu_torch.pipeline.loopback import LoopbackRxTx
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame

    out = {}

    def keep_streams(impl, streams):
        compress = impl.compress

        def compress_and_keep(frame):
            got = compress(frame)
            streams.append(np.asarray(got.data).copy())
            return got

        impl.compress = compress_and_keep

    def cpu_decodes(streams, codec):
        dec, out_codec = decompress_init(codec, [Codec.UYVY, Codec.RGB], device="cpu")
        cache = {}
        for st in streams:
            key = st.tobytes()
            if key not in cache:
                cache[key] = dec.decompress(VideoFrame(VideoDesc(W1080, H1080, codec, 60.0), [st]), out_codec).data
        return [cache[st.tobytes()] for st in streams]

    codecs = {"jpegxs": Codec.JPEG_XS, "openapv": Codec.APV, "cineform": Codec.CFHD, "j2k": Codec.J2KR}
    for spec, n in CODEC_LIVE:
        streams = []
        run, kept, _ = live_run(dev, LIVE_CAPTURE, spec, FEC, n, loss=LIVE_LOSS, keep_every=1,
                                tap=lambda sender, streams=streams: keep_streams(sender.compress.impl, streams),
                                grace_s=CODEC_GRACE_S, idle_s=CODEC_IDLE_S)
        want = cpu_decodes(streams, codecs[spec.split(":")[0]])
        k = 0
        for i, f in enumerate(kept):
            while k < len(want) and not torch.equal(f.cpu(), want[k]):
                k += 1
            if k == len(want):
                raise RuntimeError(f"live {spec}: displayed frame {i} is no CPU decode of a sent stream, in order")
            k += 1
        recovery = ldgm_packet_recovery(streams[0], 1500)
        if recovery["packets_recoverable"] != recovery["data_packets"]:
            raise RuntimeError(f"live {spec}: not every lost packet is recoverable at MTU 1500 ({recovery}); "
                               "record it under ROADMAP F6 and assert that reading here")
        if (run["frames_sent"] != n or not kept or run["frames_off_card"] or run["packets_dropped"] < 1
                or run["fec_jobs_recovered"] < 1 or run["launches"]["gf2_parity"] < 1):
            raise RuntimeError(f"live {spec}: {run}")
        run.update(displayed_frames_checked=len(kept), displayed_equal_to_cpu_decode=len(kept),
                   stream_bytes=[int(streams[0].size), int(max(x.size for x in streams))],
                   k2_launches_per_frame=run["launches"]["gf2_parity"] / n, ldgm_packet_recovery=recovery,
                   k2_peel=k2_peel_rows(dev, ((f"{spec} first frame", streams[0]),), 1500, 31))
        out[f"{spec}_ldgm_1080p"] = run
        del kept
    for spec, n in CODEC_LOOPBACK:
        streams, shown = [], []
        lb = LoopbackRxTx(LIVE_CAPTURE, "dummy", compress_spec=spec, frame_limit=n, device=dev)
        keep_streams(lb.compress.impl, streams)
        orig = lb.display.put_frame
        lb.display.put_frame = lambda f, blocking=True, orig=orig: (
            shown.append(None if f is None else f.data.clone()), orig(f, blocking))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = lb.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        frames = [f for f in shown if f is not None]
        want = cpu_decodes(streams, codecs[spec.split(":")[0]])
        on_card = [f.device.type == torch.device(dev).type for f in frames]
        if got != n or len(frames) != n or not all(on_card) or \
                not all(torch.equal(f.cpu(), w) for f, w in zip(frames, want)):
            raise RuntimeError(f"loopback {spec}: {got} of {n} shown, on the card and equal to the CPU decode: "
                               f"{on_card}")
        out[f"loopback_{spec}"] = {"frames_shown": got, "frames_per_s": got / secs, "all_on_card": True,
                                   "equal_to_cpu_decode": n, "stream_bytes": int(streams[0].size)}
    return out


# ---- slice 9: audio in the live session, and its record and replay (no
# new kernel: audio is host numpy as in the reference; K1 runs per video
# frame, K2 in the peel, the audio RS parity product on the card) ----

# 48 kHz stereo 16-bit: 3,840 bytes a channel per 1/25 s; at 997 Hz a 1/25 s
# chunk holds 39.88 cycles, so each frame differs from the one before (at
# the default 1 kHz every frame would be the same 40 cycles)
AUDIO_CAPTURE = "testcard:frequency=997"
AUDIO_FEC = "rs:16:24"
AUDIO_FEC_REF_EXAMPLE = "rs:200:240"  # the reference's own example
AUDIO_CHUNK = 48000 // 25  # samples per audio frame (the sender's audio thread)
RECORD_FRAMES = 30


def drop_audio_packets(session, per_frame: int, seed: int):
    """Drop ``per_frame`` seeded packets of every audio frame out of the
    audio session's sends, so they never reach the receiver: a frame's
    packets are held until its M bit, then sent less the dropped ones.
    Returns the list the dropped counts go to."""
    rng = np.random.default_rng(seed)
    send = session.send_data_hdr
    held, dropped = [], []

    def send_data_hdr(ts, pt, m, payload_hdr, data, *args, **kwargs):
        held.append((ts, pt, m, payload_hdr, data))
        if not m:
            return
        lost = set(rng.choice(len(held), min(per_frame, len(held)), replace=False).tolist())
        for i, pkt in enumerate(held):
            if i not in lost:
                send(*pkt)
        dropped.append(len(lost))
        held.clear()

    session.send_data_hdr = send_data_hdr
    return dropped


def audio_taps(recv, sender, loss: int, seed: int = 23):
    """Hooks on the two ends of a session's audio: each frame the sender's
    audio Tx is given, under the RTP timestamp its packets carry; each frame
    played, under the timestamp of the buffer it was decoded from; the send
    -> playback latency (the RTP timestamp is the sender's 90 kHz clock on
    this host); and ``loss`` seeded packets of every frame dropped before
    the socket."""
    taps = {"sent": {}, "played": [], "latency_ms": [], "dropped": [], "pending": [None], "rx_ts": [None]}
    if loss:
        taps["dropped"] = drop_audio_packets(sender.audio_session, loss, seed)
    send = sender.audio_tx.send_audio

    def send_audio(session, frame, *args, **kwargs):
        taps["pending"][0] = [np.array(c, copy=True) for c in frame.channels]
        return send(session, frame, *args, **kwargs)

    sender.audio_tx.send_audio = send_audio
    send_hdr = sender.audio_session.send_data_hdr

    def send_data_hdr(ts, *args, **kwargs):
        if taps["pending"][0] is not None:
            taps["sent"][ts] = taps["pending"][0]
            taps["pending"][0] = None
        return send_hdr(ts, *args, **kwargs)

    sender.audio_session.send_data_hdr = send_data_hdr
    put = recv.audio_playback.put_frame

    def put_frame(frame):
        if frame is not None:
            taps["played"].append((taps["rx_ts"][0], [np.array(c, copy=True) for c in frame.channels]))
        put(frame)

    recv.audio_playback.put_frame = put_frame
    handle = recv._handle_audio

    def handle_audio(node):
        taps["rx_ts"][0] = node.ts
        ok = handle(node)
        if ok:
            taps["latency_ms"].append(((int(time.monotonic() * 90000) - node.ts) & 0xFFFFFFFF) / 90.0)
        return ok

    recv._handle_audio = handle_audio
    return taps


def audio_result(taps, sender, audio_fec: str) -> dict:
    """The audio numbers of one session.  Each played frame is held to the
    frame sent under its RTP timestamp, byte for byte and channel by
    channel, and the timestamps played must rise; the sent frames must each
    differ from the one before, or the check could not see a repeated or
    reordered buffer."""
    sent, played = taps["sent"], taps["played"]
    order = sorted(sent)
    distinct = sum(not all(np.array_equal(a, b) for a, b in zip(sent[t0], sent[t1]))
                   for t0, t1 in zip(order, order[1:]))
    equal = sum(ts in sent and len(sent[ts]) == len(chans)
                and all(np.array_equal(a, b) for a, b in zip(sent[ts], chans)) for ts, chans in played)
    rising = all(a[0] < b[0] for a, b in zip(played, played[1:]))
    first = next(iter(sent.values()), None)
    lat = sorted(taps["latency_ms"])
    return {"fec": audio_fec, "frames_sent": len(sent), "frames_played": len(played),
            "frames_played_equal_to_sent_at_their_timestamp": equal, "timestamps_played_rising": rising,
            "sent_frames_differing_from_the_one_before": distinct, "packets_dropped": int(sum(taps["dropped"])),
            "bytes_per_channel": int(first[0].size) if first else 0, "tx_device": str(sender.audio_tx.device),
            "latency_ms_p50": lat[len(lat) // 2] if lat else None,
            "latency_ms_p95": lat[min(len(lat) - 1, int(len(lat) * 0.95))] if lat else None}


def audio_ok(a: dict) -> bool:
    """Every played frame is the one sent under its timestamp, in order, and
    the sent frames are distinguishable from their neighbours."""
    return (a["frames_played"] >= 1 and a["frames_played_equal_to_sent_at_their_timestamp"] == a["frames_played"]
            and a["timestamps_played_rising"]
            and a["sent_frames_differing_from_the_one_before"] == a["frames_sent"] - 1)


def rs_packet_recovery(spec: str, nsamples: int = AUDIO_CHUNK, mtu: int = 1500) -> dict:
    """One 48 kHz stereo 16-bit audio frame of ``nsamples`` through the
    port's Tx with ``-f A:<spec>``, on the CPU: its packets, RS symbol size,
    the most symbols a packet spans, and at how many packet positions the
    loss of that one packet is recovered exactly by ``AudioRxState``."""
    from ultragrid_tpu_torch.audio.types import AudioDesc, AudioFrame
    from ultragrid_tpu_torch.net import rtp_types as rt
    from ultragrid_tpu_torch.net.audio_rx import AudioRxState
    from ultragrid_tpu_torch.net.pbuf import PbufNode
    from ultragrid_tpu_torch.net.rtp import RtpPacket
    from ultragrid_tpu_torch.net.transmit import Tx

    class Recorder:
        def __init__(self):
            self.packets = []

        def send_data_hdr(self, ts, pt, m, payload_hdr, data):
            self.packets.append((pt, m, payload_hdr + data))

    rng = np.random.default_rng(5)
    frame = AudioFrame(AudioDesc(), [rng.integers(0, 256, nsamples * 2, dtype=np.uint8) for _ in range(2)])
    rec = Recorder()
    Tx(mtu=mtu, device="cpu").send_audio(rec, frame, "PCM", fec_spec=spec)
    k, n = (int(x) for x in spec.split(":")[1:3])
    hdrs = [rt.parse_audio_header(p[: rt.AUDIO_PAYLOAD_HDR_LEN]) for _, _, p in rec.packets]
    ss = hdrs[0][3] // n
    spans = [(off + len(p) - rt.AUDIO_PAYLOAD_HDR_LEN - 1) // ss - off // ss + 1
             for (_, _, p), (_, _, off, _, _, _, _) in zip(rec.packets, hdrs)]
    state = AudioRxState()
    ok = 0
    for lost in range(len(rec.packets)):
        node = PbufNode(0, 0.0, 0.0)
        for i, (pt, m, payload) in enumerate(rec.packets):
            if i != lost:
                node.insert_packet(RtpPacket(pt, i, 0, 0, m, payload, 0.0))
        out = state.decode_frame(node)
        ok += out is not None and all(np.array_equal(out.channels[c], frame.channels[c]) for c in range(2))
    return {"spec": spec, "mtu": mtu, "bytes_per_channel": nsamples * 2, "symbol_size": ss, "parity_symbols": n - k,
            "max_symbols_per_packet": max(spans), "packets_per_frame": len(rec.packets),
            "packets_whose_loss_is_recovered": int(ok)}


TWO_PROC_FRAMES = 600  # the sender's --frames: 10 s at 60 fps, against a start-up of seconds
TWO_PROC_SHOWN = 540  # the receiver's --frames: it stops by itself once it has shown 90% of them
TWO_PROC_GRACE_S = 5.0  # how long the receiver may run on after the sender has exited


def cli_two_processes(dev, frames: int = TWO_PROC_FRAMES, shown: int = TWO_PROC_SHOWN,
                      capture: str = LIVE_CAPTURE) -> dict:
    """The session as a user starts it, in two processes: ``python -m
    ultragrid_tpu_torch -d dummy -r wav:<tmp> --frames <shown>`` and, once
    its control socket is up, the sender ``-t <capture> -c jpeg:80 -f
    V:ldgm:256:26:5 -f A:rs:16:24 -s testcard:frequency=997 --frames
    <frames>`` over 127.0.0.1, no packet dropped.  The receiver stops by
    itself once it has shown ``shown`` frames; else it is stopped
    ``TWO_PROC_GRACE_S`` after the sender exits.  Its display reports the
    frames shown so far on the first frame 5 s or more after its start or
    its report before, so the first report, coming after the sender's
    start-up, times the first frame shown.  Each 1/25 s frame of the played
    wav must be one of the testcard's chunks, later than the one before; the
    row counts the chunks missing between the first and the last played."""
    import re
    import signal
    import wave

    from ultragrid_tpu_torch.audio.capture import initialize_audio_capture

    dev_args = [] if torch.device(dev).type == "cuda" else ["--device", "cpu"]
    port = free_port_pair(3)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_two_proc_")
    wav_path = os.path.join(tmp, "played.wav")
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=ROOT)
    uv = [sys.executable, "-m", "ultragrid_tpu_torch"]
    rx_cmd = uv + ["-d", "dummy", "-r", f"wav:{wav_path}", "-P", str(port), "-n", "0", "--frames", str(shown),
                   *dev_args]
    tx_cmd = uv + ["-t", capture, "-c", "jpeg:80", "-f", "V:" + FEC, "-f", "A:" + AUDIO_FEC, "-s", AUDIO_CAPTURE,
                   "-P", str(port), "-n", "0", "--frames", str(frames), *dev_args, "127.0.0.1"]
    lines = {"rx": [], "tx": []}

    def start(which, cmd):
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        def read():
            for ln in proc.stdout:
                lines[which].append((time.monotonic(), ln.rstrip()))

        threading.Thread(target=read, daemon=True).start()
        return proc

    procs = []
    try:
        t_rx = time.monotonic()
        rx = start("rx", rx_cmd)
        procs.append(rx)
        while not any("control socket on" in ln for _, ln in lines["rx"]):
            if rx.poll() is not None or time.monotonic() - t_rx > 120:
                raise RuntimeError(f"two processes: the receiver did not come up: {lines['rx'][-5:]}")
            time.sleep(0.05)
        t_tx = time.monotonic()
        tx = start("tx", tx_cmd)
        procs.append(tx)
        tx_rc = tx.wait(timeout=120 + frames / 10)
        tx_s = time.monotonic() - t_tx
        try:
            rx_rc = rx.wait(timeout=TWO_PROC_GRACE_S)
            stopped_by_itself = True
        except subprocess.TimeoutExpired:
            rx.send_signal(signal.SIGTERM)
            rx_rc = rx.wait(timeout=30)
            stopped_by_itself = False
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    reports = [(int(m.group(1)), t - t_tx) for t, ln in lines["rx"]
               for m in [re.search(r"\[display\] (\d+) frames in ", ln)] if m]
    total = [(int(m.group(1)), t - t_tx) for t, ln in lines["rx"]
             for m in [re.search(r"displayed (\d+) frames", ln)] if m]
    with wave.open(wav_path, "rb") as wf:
        raw = np.frombuffer(wf.readframes(wf.getnframes()), np.uint8)
    shutil.rmtree(tmp, ignore_errors=True)
    # the testcard's chunks as the sender's audio thread reads them
    chunk_bytes = AUDIO_CHUNK * 2 * 2
    cap = initialize_audio_capture(AUDIO_CAPTURE)
    chunks = [cap.read(AUDIO_CHUNK).to_interleaved().tobytes() for _ in range(int(tx_s * 25) + 50)]
    at = []
    for j in range(raw.size // chunk_bytes):
        played = raw[j * chunk_bytes:(j + 1) * chunk_bytes].tobytes()
        hit = next((i for i in range((at[-1] + 1) if at else 0, len(chunks)) if chunks[i] == played), None)
        if hit is not None:
            at.append(hit)
    return {"capture": capture, "frames_sent": frames, "sender_rc": tx_rc, "sender_seconds": tx_s,
            "receiver_frames_limit": shown, "receiver_rc": rx_rc, "receiver_stopped_by_itself": stopped_by_itself,
            "receiver_stopped_s_after_sender_start": total[0][1] if total else None,
            "frames_shown": total[0][0] if total else max((n for n, _ in reports), default=0),
            "frames_shown_is_a_lower_bound": not total,
            "first_frame_shown_s_after_sender_start": reports[0][1] if reports and reports[0][0] == 1 else None,
            "display_reports": [{"frames_shown": n, "at_s_after_sender_start": t} for n, t in reports],
            "frames_dropped_by_the_receiver": sum("dropping frame" in ln for _, ln in lines["rx"]),
            "audio": {"fec": AUDIO_FEC, "frames_played": raw.size // chunk_bytes,
                      "frames_equal_to_a_testcard_chunk_in_order": len(at),
                      "chunks_missing_between_first_and_last_played": (at[-1] - at[0] + 1 - len(at)) if at else None},
            "receiver_tail": [ln for _, ln in lines["rx"][-3:]], "sender_tail": [ln for _, ln in lines["tx"][-3:]]}


def cli_receiver(argv):
    """The VideoReceiver that ``cli.main(argv)`` builds, not run."""
    from ultragrid_tpu_torch import cli
    from ultragrid_tpu_torch.pipeline import receiver as receiver_mod

    built = []
    run = receiver_mod.VideoReceiver.run
    receiver_mod.VideoReceiver.run = lambda self: built.append(self) or 0
    try:
        rc = cli.main(argv)
    finally:
        receiver_mod.VideoReceiver.run = run
    if rc != 0 or len(built) != 1:
        raise RuntimeError(f"cli {argv}: rc {rc}, {len(built)} receivers built")
    return built[0]


def phase_audio_session(dev):
    """Audio in the live session, through the port's sender and receiver (what
    the CLI builds for ``-s testcard -f A:rs:16:24 -r wav:<tmp>``): (a) the
    1080p60 JPEG + LDGM session of phase ``live_session`` with audio, one
    seeded video packet and one seeded audio packet dropped per frame at MTU
    1500 (every played audio frame equal to the one sent under its RTP
    timestamp, every kept video frame on the card and a ring frame's encode
    -> decode), the same row without audio, and the reference's example
    ``A:rs:200:240``; (b)
    ``--audio-delay`` on the receiver the CLI builds; (c) ``-E`` on a
    30-frame 1080p60 sender, then the recording through ``ImportCapture``
    and as ``-I``'s capture; (d) the audio RS parity on the card against the
    CPU's; (e) the CLI's receiver and sender in two processes."""
    import struct
    import wave

    from ultragrid_tpu_torch.ops.fec import fec_from_spec
    from ultragrid_tpu_torch.pipeline.sender import VideoSender
    from ultragrid_tpu_torch.utils.export import ImportCapture

    t_phase = time.perf_counter()
    out = {"phase": "audio_session"}
    # the recovery table on the CPU: at 16:24 any one lost packet of an audio
    # thread's frame is recoverable; at the reference's 200:240 only the
    # short tails are; -I's embedded chunk of one 60 fps frame (800 samples)
    # is read, not gated
    rec = {spec: rs_packet_recovery(spec) for spec in (AUDIO_FEC, AUDIO_FEC_REF_EXAMPLE)}
    rec[AUDIO_FEC + " at 800 samples"] = rs_packet_recovery(AUDIO_FEC, 48000 // 60)
    out["rs_recovery"] = rec
    r = rec[AUDIO_FEC]
    if (r["packets_whose_loss_is_recovered"] != r["packets_per_frame"]
            or r["max_symbols_per_packet"] > r["parity_symbols"]):
        raise RuntimeError(f"A:{AUDIO_FEC}: not every packet's loss is recoverable: {r}")

    # (a) the session with audio, the same without, the reference's example
    jpeg = "jpeg:80"
    # the row without audio first: both rows then run warm (the first session
    # of a process pays its threads' first decode)
    out["jpeg_ldgm_no_audio_1080p"] = live_run(dev, LIVE_CAPTURE, jpeg, FEC, LIVE_FRAMES, loss=LIVE_LOSS)[0]
    main_run, kept, sender = live_run(dev, LIVE_CAPTURE, jpeg, FEC, LIVE_FRAMES, loss=LIVE_LOSS, keep_every=20,
                                      audio_capture=AUDIO_CAPTURE, audio_fec=AUDIO_FEC, audio_loss=1)
    a = main_run["audio"]
    if (main_run["frames_displayed"] < LIVE_FRAMES // 2 or main_run["frames_off_card"]
            or min(main_run["launches"]["jpeg_encode"], main_run["launches"]["gf2_parity"]) < 1
            or main_run["fec_jobs_recovered"] < 1):
        raise RuntimeError(f"audio session, video: {main_run}")
    check_card_decode("audio session, video", main_run["launches"], main_run["frames_displayed"])
    if (not audio_ok(a) or a["packets_dropped"] < a["frames_played"]
            or not a["tx_device"].startswith(torch.device(dev).type)):
        raise RuntimeError(f"audio session, audio: {a}")
    matched, _ = jpeg_ring_matches(dev, kept, sender.capture.frames, "audio session 1080p jpeg")
    main_run.update(displayed_frames_checked=len(kept), ring_frames_matched=len(matched))
    out["jpeg_ldgm_audio_1080p"] = main_run
    out["jpeg_ldgm_audio_ref_example"] = live_run(dev, LIVE_CAPTURE, jpeg, FEC, 30, loss=LIVE_LOSS,
                                                  audio_capture=AUDIO_CAPTURE, audio_fec=AUDIO_FEC_REF_EXAMPLE,
                                                  audio_loss=1)[0]

    # (b) --audio-delay on the receiver the CLI builds (ref: 0.232 / 0.032 s
    # and 0.032 / 0.132 s at the default 32 ms playout delay)
    delays = {}
    for ms, want in ((200, (0.232, 0.032)), (-100, (0.032, 0.132))):
        recv = cli_receiver(["-d", "dummy", "-r", "dummy", f"--audio-delay={ms}", "-P", str(free_port_pair(3)),
                             "-n", "0", "--device", torch.device(dev).type])
        got = (recv.audio_pbuf.playout_delay, recv.pbuf.playout_delay)
        recv.session.close()
        recv.audio_session.close()
        recv.display.done()
        if any(abs(g - w) > 1e-9 for g, w in zip(got, want)) or recv.device.type != torch.device(dev).type:
            raise RuntimeError(f"--audio-delay {ms}: audio/video playout delays {got}, want {want}")
        delays[str(ms)] = {"audio_playout_s": got[0], "video_playout_s": got[1]}
    out["audio_delay"] = delays

    # (c) -E, then the recording through ImportCapture and as -I's capture
    rec_dir = tempfile.mkdtemp(prefix="chip_smoke_record_")
    try:
        recorder = VideoSender(LIVE_CAPTURE, "127.0.0.1", tx_port=free_port_pair(3), frame_limit=RECORD_FRAMES,
                               audio_capture=AUDIO_CAPTURE, record=rec_dir, device=dev)
        n_rec = recorder.run()
        ring = recorder.capture.frames
        cap = ImportCapture(rec_dir, device=dev)
        if n_rec != RECORD_FRAMES or cap.frame_count != n_rec:
            raise RuntimeError(f"-E: {n_rec} sent, {cap.frame_count} recorded")
        read_ms, up_ms = [], []
        for i in range(n_rec):
            t0 = time.perf_counter()
            host = cap.read_host(i)
            t1 = time.perf_counter()
            card = torch.from_numpy(host).to(dev)
            torch.cuda.synchronize()
            up_ms.append((time.perf_counter() - t1) * 1e3)
            read_ms.append((t1 - t0) * 1e3)
            frame = cap.frame_at(i)
            if frame.data.device != card.device or not torch.equal(frame.data, card):
                raise RuntimeError(f"ImportCapture frame {i} is not the recording on {dev}")
            if not any(torch.equal(card, r_) for r_ in ring):
                raise RuntimeError(f"-E frame {i} is no testcard frame")
        cap.done()
        with wave.open(os.path.join(rec_dir, "sound.wav"), "rb") as wf:
            wav = np.frombuffer(wf.readframes(wf.getnframes()), np.uint8)
        grabbed, replayed = [], []

        def tap(snd):
            grab, send = snd.capture.grab, snd.audio_tx.send_audio

            def grab_checked():
                frame, audio = grab()
                grabbed.append(frame is None or frame.data.device.type == torch.device(dev).type)
                return frame, audio

            def send_recorded(session, frame, *args, **kwargs):
                replayed.append(frame.to_interleaved().copy())
                return send(session, frame, *args, **kwargs)

            snd.capture.grab = grab_checked
            snd.audio_tx.send_audio = send_recorded

        # no audio packet is dropped here: -I's embedded chunk of one 60 fps
        # frame spans packets of more symbols than 16:24 has parity (see
        # rs_recovery); row (a) is the audio loss row
        replay, kept_r, _ = live_run(dev, f"import:{rec_dir}", jpeg, FEC, n_rec, loss=LIVE_LOSS, keep_every=5,
                                     tap=tap, audio_capture="embedded", audio_fec=AUDIO_FEC)
        ra = replay["audio"]
        sent_bytes = np.concatenate(replayed) if replayed else np.zeros(0, np.uint8)
        if (not all(grabbed) or replay["frames_displayed"] < n_rec // 2 or not replayed
                or not np.array_equal(sent_bytes, wav[:sent_bytes.size])
                or not audio_ok(ra)):
            raise RuntimeError(f"-I replay: {len(replayed)} audio frames, wav {wav.size} B, {replay}")
        check_card_decode("-I replay", replay["launches"], replay["frames_displayed"])
        matched_r, _ = jpeg_ring_matches(dev, kept_r, ring, "-I replay")
        replay.update(displayed_frames_checked=len(kept_r), ring_frames_matched=len(matched_r),
                      grabs_on_card=len(grabbed), audio_bytes_replayed_equal_to_wav=int(sent_bytes.size))
        out["record_replay"] = {"frames_recorded": n_rec, "wav_bytes": int(wav.size),
                                "frames_equal_to_the_recording_on_card": n_rec,
                                "import_read_ms_per_frame": float(np.mean(read_ms)),
                                "import_upload_ms_per_frame": float(np.mean(up_ms)), "replay": replay}
    finally:
        shutil.rmtree(rec_dir, ignore_errors=True)

    # (d) the audio RS parity product on the card against the CPU's, at the
    # audio thread's chunk and at -I's chunk of one 60 fps frame
    rng = np.random.default_rng(31)
    rs_rows = []
    for spec in (AUDIO_FEC, AUDIO_FEC_REF_EXAMPLE):
        rs = fec_from_spec(spec)
        for nbytes in (AUDIO_CHUNK * 2, 48000 // 60 * 2):
            data = rng.integers(0, 256, nbytes, dtype=np.uint8)
            hdr = struct.pack("<I", 1)
            card, fd = rs.encode(data, hdr=hdr, device=dev)
            cpu, _ = rs.encode(data, hdr=hdr, device="cpu")
            if not np.array_equal(card, cpu):
                raise RuntimeError(f"RS {spec} parity on {dev} differs from the CPU's at {nbytes} B")
            rs_rows.append({"spec": spec, "bytes_per_channel": nbytes, "symbol_size": fd.symbol_size,
                            "equal_to_cpu": True, "encode_ms_card": host_ms(lambda: rs.encode(data, hdr=hdr,
                                                                                            device=dev), 20),
                            "encode_ms_cpu": host_ms(lambda: rs.encode(data, hdr=hdr, device="cpu"), 20)})
    out["rs_parity"] = rs_rows

    # (e) the CLI in two processes, as a user runs it
    two = cli_two_processes(dev)
    ta = two["audio"]
    if (two["sender_rc"] != 0 or not two["receiver_stopped_by_itself"] or two["receiver_rc"] != 0
            or two["frames_shown"] < TWO_PROC_SHOWN or ta["frames_played"] < 1
            or ta["frames_equal_to_a_testcard_chunk_in_order"] != ta["frames_played"]):
        raise RuntimeError(f"the CLI in two processes: {two}")
    out["cli_two_processes"] = two
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- slice 10: standards-mode RTP and RTSP, the full-duplex session, the
# preview socket with thumbnailgen, iHDTV (K1 on every sender, K2 in the
# duplex session's peel; no new kernel) ----

STD_FRAMES = 120
RTSP_H264_FRAMES = 60
RTSP_H264_GOP = 30
# the harness camera's paces: row (c) at 15 frames/s, as before the capture
# decoded off its rx thread; row (c') at 30, where the reference's capture,
# which decodes on its rx thread, overruns its socket (a 1080p access unit of
# this content takes the own decoder longer than 1/30 s)
RTSP_H264_FPS = 15
RTSP_H264_FPS_FAST = 30
DUPLEX_FRAMES = 120
PREVIEW_FRAMES = 60
THUMBNAILS = 5
IHDTV_FRAMES = 30


def tap_sent_files(sender, files: dict, packets: list) -> None:
    """Each JPEG file the sender's Tx is given, under its RTP timestamp, and
    the packets it went out in."""
    send = sender.tx.send_video

    def send_video(session, frame):
        data = frame.data.cpu().numpy() if isinstance(frame.data, torch.Tensor) else np.asarray(frame.data)
        files[int(frame.timestamp * 90000) & 0xFFFFFFFF] = data.tobytes()
        packets.append(send(session, frame))
        return packets[-1]

    sender.tx.send_video = send_video


class CpuJpegDecodes:
    """The CPU plain path's decode of each distinct JPEG file to UYVY."""

    def __init__(self):
        from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress

        self.dec = JpegDecompress(device="cpu")
        self.done = {}

    def __call__(self, file: bytes) -> torch.Tensor:
        from ultragrid_tpu_torch.ops.jpeg import _parse_headers
        from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame

        if file not in self.done:
            hdr = _parse_headers(file)
            frame = VideoFrame(VideoDesc(hdr["w"], hdr["h"], Codec.JPEG, 60.0), [np.frombuffer(file, np.uint8)])
            self.done[file] = self.dec.decompress(frame, Codec.UYVY).data
        return self.done[file]


def standards_session(dev, cpu_decode):
    """(a) ``--rtp-standard``: the 1080p60 sender, JPEG q80 as RFC 2435 on
    PT 26 with no FEC, to the port's receiver on the card; every shown frame
    against the CPU decode of the file sent under its RTP timestamp; the
    SDP the sender serves over HTTP."""
    import urllib.request

    from ultragrid_tpu_torch.net.rtsp_client import parse_sdp
    from ultragrid_tpu_torch.utils.sdp import DEFAULT_SDP_HTTP_PORT

    files, shown, sdp, packets = {}, [], [], []

    def tap(sender):
        if sender.sdp_server is None:
            raise RuntimeError(f"standards session: the SDP HTTP server could not bind port "
                               f"{DEFAULT_SDP_HTTP_PORT} (taken on this machine)")
        with urllib.request.urlopen(f"http://127.0.0.1:{sender.sdp_server.port}/ultragrid.sdp", timeout=5) as r:
            sdp.append(r.read().decode())
        tap_sent_files(sender, files, packets)

    def on_shown(frame):
        shown.append((int(round(frame.timestamp * 90000)) & 0xFFFFFFFF, frame.data.clone()))

    # a session's first run in a process pays its threads' warm-up: a
    # 30-frame run first, recorded and not gated
    warm, _, _ = live_run(dev, LIVE_CAPTURE, "jpeg:80", "none", 30, sender_kw={"rtp_standard": True})
    # the per-packet Python of the standards payload at each end, timed by
    # the host clock around the sender's RFC 2435 send and the receiver's
    # reassembly of one frame
    from ultragrid_tpu_torch.net.transmit import Tx
    from ultragrid_tpu_torch.net.video_rx import VideoRxState

    timed = {"send": [], "reassemble": []}
    patched = [(Tx, "_send_rfc2435", "send"), (VideoRxState, "_decode_rfc2435", "reassemble")]
    saved = [getattr(cls, name) for cls, name, _ in patched]

    def timing(fn, key):
        def timed_fn(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                timed[key].append((time.perf_counter() - t0) * 1e3)
        return timed_fn

    for (cls, name, key), fn in zip(patched, saved):
        setattr(cls, name, timing(fn, key))
    try:
        run, _, sender = live_run(dev, LIVE_CAPTURE, "jpeg:80", "none", STD_FRAMES, tap=tap, on_shown=on_shown,
                                  sender_kw={"rtp_standard": True})
    finally:
        for (cls, name, _), fn in zip(patched, saved):
            setattr(cls, name, fn)
    medias = parse_sdp(sdp[0])
    if [(m.kind, m.payload_type, m.encoding, m.clock) for m in medias] != [("video", 26, "JPEG", 90000)]:
        raise RuntimeError(f"standards session: the served SDP is {sdp[0]!r}")
    if run["frames_displayed"] < STD_FRAMES // 2 or run["frames_off_card"] or run["launches"]["jpeg_encode"] < 1:
        raise RuntimeError(f"standards session: {run}")
    if sender.tx.rfc2435 is not True or sender.rtsp_server is not None:
        raise RuntimeError("standards session: the sender is not in standards mode")
    for ts, data in shown:
        if ts not in files:
            raise RuntimeError(f"standards session: a shown frame has no sent file under RTP ts {ts}")
        if not torch.equal(data.cpu(), cpu_decode(files[ts])):
            nd, err = byte_diff(data.cpu(), cpu_decode(files[ts]))
            raise RuntimeError(f"standards session: a shown frame differs from the CPU decode of its file "
                               f"({nd} bytes, max {err})")
    run.update(warmup_30_frames={k: warm[k] for k in ("frames_displayed", "frames_per_s", "latency_ms_p50",
                                                       "latency_ms_p95", "frames_missing_data")},
               frames_checked=len(shown), equal_to_cpu_decode=True, distinct_files=len(set(files.values())),
               sdp=sdp[0], rtp_packets_per_frame_median=sorted(packets)[len(packets) // 2],
               send_ms_median=sorted(timed["send"])[len(timed["send"]) // 2],
               reassemble_ms_median=sorted(timed["reassemble"])[len(timed["reassemble"]) // 2],
               reassemble_ms_max=max(timed["reassemble"]),
               jpeg_bytes_median=sorted(len(f) for f in files.values())[len(files) // 2])
    return run


def rtsp_jpeg_capture(dev, cpu_decode, frames: int = STD_FRAMES):
    """(b) a ``--rtsp`` sender (no host: it serves and waits for PLAY) at the
    same setting, and the port's RtspCapture on the card feeding a local
    loop to a display; every captured frame against the CPU decode of the
    file it was sent as.  The RTSP server binds the reference's port 8554:
    if that is taken here, the row fails and says so."""
    from ultragrid_tpu_torch.modules import extra_displays
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.modules.video_display import initialize_video_display
    from ultragrid_tpu_torch.net.rtsp import DEFAULT_RTSP_PORT
    from ultragrid_tpu_torch.pipeline.loop import CaptureToDisplayPipeline
    from ultragrid_tpu_torch.pipeline.sender import VideoSender

    sender = VideoSender(LIVE_CAPTURE, None, compress_spec="jpeg:80", tx_port=free_port_pair(),
                         rtp_standard=True, rtsp=True, device=dev)
    if sender.rtsp_server is None:
        raise RuntimeError(f"rtsp: the sender's RTSP server could not bind port {DEFAULT_RTSP_PORT} "
                           "(taken on this machine); the row does not move to another port")
    # ROADMAP F10: the SDP HTTP server wants the same port and cannot start
    sdp_started = sender.sdp_server is not None
    files, packets = {}, []
    tap_sent_files(sender, files, packets)
    st = threading.Thread(target=sender.run, name="rtsp-sender", daemon=True)
    st.start()
    got = []
    extra_displays.register_pipe_delegate(
        "chip_rtsp", lambda f: got.append((time.perf_counter(), f.data.clone())) if f is not None else None)
    time.sleep(0.2)
    reset_kernel_counts()
    t0 = time.perf_counter()
    try:
        cap = initialize_video_capture(f"rtsp:rtsp://127.0.0.1:{sender.rtsp_server.port}/ultragrid", device=dev)
        disp = initialize_video_display("pipe:chip_rtsp", device=dev)
        try:
            n = CaptureToDisplayPipeline(cap, disp, frames).run()
        finally:
            disp.done()
            cap.done()
    finally:
        sender.should_exit.set()
        st.join(timeout=30)
    torch.cuda.synchronize()
    launches = kernel_counts()
    if st.is_alive():
        raise RuntimeError("rtsp: the sender did not stop")
    if n < frames or len(got) < frames or cap.decode_failures or launches["jpeg_encode"] < 1:
        raise RuntimeError(f"rtsp: {n} captured, {len(got)} shown, {cap.decode_failures} decode failures, "
                           f"launches {launches}")
    sent = {f: cpu_decode(f) for f in set(files.values())}
    for _, data in got:
        if data.device.type != torch.device(dev).type:
            raise RuntimeError(f"rtsp: a captured frame is on {data.device}")
        if not any(torch.equal(data.cpu(), want) for want in sent.values()):
            raise RuntimeError("rtsp: a captured frame is no sent file's CPU decode")
    t_first, t_last = got[0][0], got[-1][0]
    return {"capture": f"rtsp:rtsp://127.0.0.1:{sender.rtsp_server.port}/ultragrid", "sender": LIVE_CAPTURE,
            "frames_captured": n, "frames_shown": len(got), "frames_checked": len(got),
            "equal_to_cpu_decode": True, "decode_failures": cap.decode_failures,
            "describe_to_first_frame_ms": (t_first - t0) * 1e3,
            "frames_per_s": (len(got) - 1) / (t_last - t_first) if len(got) > 1 else 0.0,
            "launches": launches, "sdp_http_server_started": sdp_started,
            "f10_sdp_http_server_refused": not sdp_started}


def rtsp_h264_stream(dev):
    """The harness camera's stream: the port's 1080p device encoder's access
    units (IDR + P, GOP 30) of ``RTSP_H264_FRAMES`` panned frames, each
    with the encoder's reference picture as UYVY, and the SPS and PPS as
    ``sprop-parameter-sets``."""
    import base64

    from ultragrid_tpu_torch.net import rtpdec_h264
    from ultragrid_tpu_torch.ops.h264_device import InterEncoderDevice
    from ultragrid_tpu_torch.ops.planar import i420_8_to_uyvy

    enc = InterEncoderDevice(W1080, H1080, qp=H264_QP, gop=RTSP_H264_GOP, device=dev)
    aus, want = [], []
    for f in h264_sequence(RTSP_H264_FRAMES, seed=71):
        aus.append(enc.encode_uyvy(torch.as_tensor(f).to(dev)))
        y, cb, cr = enc.ref
        flat = torch.cat([y[:H1080, :W1080].reshape(-1), cb[:H1080 // 2, :W1080 // 2].reshape(-1),
                          cr[:H1080 // 2, :W1080 // 2].reshape(-1)])
        want.append(i420_8_to_uyvy(flat, W1080, H1080))
    ps = {rtpdec_h264.nal_type(n[0]): n for n in rtpdec_h264.packetize(aus[0], mtu_payload=1 << 30)}
    sprop = ",".join(base64.b64encode(ps[t]).decode() for t in (rtpdec_h264.NAL_SPS, rtpdec_h264.NAL_PPS))
    return aus, want, sprop


def rtsp_h264_capture(dev, stream, fps: int, every: bool):
    """(c) an IP camera's stream at ``fps``: an RtspServer announcing H264
    (PT 96) with sprop-parameter-sets, pumping ``stream``'s access units
    split by ``rtpdec_h264.packetize``, each access unit's packets spread
    over half a frame period as a camera paces them; RtspCapture decodes
    them on the card (OwnH264Decompress) and every decoded frame must equal
    the encoder's reference picture, in order.  With ``every``, each access
    unit must come out (row (c'), the capture decoding off its rx thread);
    without, at least half (row (c))."""
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.net import rtpdec_h264
    from ultragrid_tpu_torch.net import rtsp as rtsp_mod
    from ultragrid_tpu_torch.net.rtp import RtpSession

    aus, want, sprop = stream
    pumped = []

    def on_play(addr, port):
        def pump():
            sess = RtpSession(addr=addr, rx_port=0, tx_port=port)
            t_next = time.perf_counter()
            for i, au in enumerate(aus):
                pkts = rtpdec_h264.packetize(au, mtu_payload=1400)
                gap = 0.5 / fps / len(pkts)
                for j, p in enumerate(pkts):
                    sess.send_data_hdr(i * (90000 // fps), 96, j == len(pkts) - 1, b"", p)
                    if j % 16 == 15:
                        time.sleep(max(0.0, t_next + (j + 1) * gap - time.perf_counter()))
                pumped.append(len(pkts))
                t_next += 1 / fps
                time.sleep(max(0.0, t_next - time.perf_counter()))
            sess.close()

        threading.Thread(target=pump, name="camera", daemon=True).start()

    make_sdp = rtsp_mod.make_sdp
    rtsp_mod.make_sdp = lambda ip, streams, name: (
        make_sdp(ip, streams, name) + f"a=fmtp:96 packetization-mode=1;sprop-parameter-sets={sprop}\r\n")
    srv = rtsp_mod.RtspServer([("video", 5004, 96, "H264", 90000)], port=0, on_play=on_play)
    got, stamps = [], []
    try:
        t0 = time.perf_counter()
        cap = initialize_video_capture(f"rtsp:rtsp://127.0.0.1:{srv.port}/camera", device=dev)
        last = time.perf_counter()
        while len(got) < RTSP_H264_FRAMES and time.perf_counter() - last < 3.0:
            frame, _ = cap.grab()
            if frame is not None:
                got.append(frame.data.clone())
                last = time.perf_counter()
                stamps.append(last)
        wall = time.perf_counter() - t0
        cap.done()
    finally:
        srv.close()
        rtsp_mod.make_sdp = make_sdp
    at = -1
    for data in got:
        hit = next((k for k in range(at + 1, len(want)) if torch.equal(data, want[k])), None)
        if hit is None:
            raise RuntimeError(f"rtsp h264 at {fps} frames/s: a decoded frame is no later reference picture "
                               "of the encoder")
        at = hit
    if len(got) < (RTSP_H264_FRAMES if every else RTSP_H264_FRAMES // 2) or cap.decode_failures:
        raise RuntimeError(f"rtsp h264 at {fps} frames/s: {len(got)} of {RTSP_H264_FRAMES} decoded, "
                           f"{cap.decode_failures} decode failures")
    return {"geometry": f"{W1080}x{H1080}", "qp": H264_QP, "gop": RTSP_H264_GOP, "access_units": len(aus),
            "camera_frames_per_s": fps, "au_bytes_idr": len(aus[0]),
            "au_bytes_p_median": sorted(len(a) for a in aus[1:])[len(aus) // 2 - 1],
            "rtp_packets_per_au_max": max(pumped) if pumped else 0, "frames_decoded": len(got),
            "equal_to_encoder_reference": True, "decode_failures": cap.decode_failures, "seconds": wall,
            "frames_per_s": (len(got) - 1) / (stamps[-1] - stamps[0]) if len(got) > 1 else None}


def drop_ldgm_packets(per_frame: int, seed: int, k: int, m: int):
    """Drop ``per_frame`` seeded LDGM data packets of every frame any RTP
    session of this process sends (for a session that ``cli.main`` builds);
    returns the restore function and the list the dropped counts go to."""
    from ultragrid_tpu_torch.net import rtp_types as rt
    from ultragrid_tpu_torch.net.rtp import RtpSession

    rng = np.random.default_rng(seed)
    send = RtpSession.send_batch
    dropped = []

    def send_batch(self, ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns=0):
        if pt == rt.PT_VIDEO_LDGM:
            data_end = np.asarray(data).size * k // (k + m)
            offsets, sizes = np.asarray(offsets), np.asarray(sizes)
            cand = np.flatnonzero(offsets + sizes <= data_end)
            lost = rng.choice(cand, min(per_frame, cand.size), replace=False)
            keep = np.setdiff1d(np.arange(sizes.size), lost)
            dropped.append(int(lost.size))
            hdrs, offsets, sizes = hdrs[keep], offsets[keep], sizes[keep]
        return send(self, ts, pt, hdrs, data, offsets, sizes, m_last, pace_ns)

    RtpSession.send_batch = send_batch

    def restore():
        RtpSession.send_batch = send

    return restore, dropped


def cli_logged(argv):
    """``cli.main(argv)`` with its log lines kept (and echoed); returns the
    exit code and the text."""
    import contextlib
    import io

    from ultragrid_tpu_torch import cli
    from ultragrid_tpu_torch.utils import params

    buf = io.StringIO()
    try:
        with contextlib.redirect_stderr(buf):
            rc = cli.main(argv)
    finally:
        params.reset_params()
        sys.stderr.write(buf.getvalue()[-3000:])
    return rc, buf.getvalue()


def duplex_calls(dev):
    """(d) the full-duplex call through ``cli.main``: a 1080p60 testcard
    sent to 127.0.0.1 and shown by the same process, JPEG + LDGM 256:26:5,
    the peel on the card (``--param ldgm-device=device``) with one data
    packet of each frame dropped before the socket; then the same with
    mono testcard audio, ``-r dummy`` and ``--echo-cancellation``."""
    import re

    out = {}
    k, m = (int(x) for x in FEC.split(":")[1:3])
    for label, extra, loss in (("video", [], LIVE_LOSS),
                               ("audio_echo_cancellation",
                                ["-s", "testcard:frequency=997:channels=1", "-r", "dummy",
                                 "--echo-cancellation"], 0)):
        port = free_port_pair(3)
        argv = ["-t", LIVE_CAPTURE, "-d", "dummy", "-c", "jpeg", "-f", FEC, "127.0.0.1", "-P", str(port),
                "-n", "0", "--frames", str(DUPLEX_FRAMES), "--param", "ldgm-device=device"] + extra
        restore, dropped = drop_ldgm_packets(loss, 29, k, m) if loss else (lambda: None, [])
        reset_kernel_counts()
        t0 = time.perf_counter()
        try:
            rc, text = cli_logged(argv)
        finally:
            restore()
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = kernel_counts()
        sent = re.search(r"sent (\d+) frames", text)
        shown = re.search(r"displayed (\d+) frames", text)
        if rc != 0 or not sent or not shown:
            raise RuntimeError(f"duplex {label}: rc {rc}, log {text[-1500:]!r}")
        row = {"argv": " ".join(argv), "frames_sent": int(sent.group(1)), "frames_displayed": int(shown.group(1)),
               "seconds": wall, "launches": launches, "packets_dropped": int(sum(dropped)),
               "echo_cancellation_active": "echo cancellation active" in text}
        if (row["frames_sent"] != DUPLEX_FRAMES or row["frames_displayed"] < DUPLEX_FRAMES // 2
                or launches["jpeg_encode"] < DUPLEX_FRAMES):
            raise RuntimeError(f"duplex {label}: {row}")
        if loss and launches["gf2_parity"] < 1:
            raise RuntimeError(f"duplex {label}: the peel did not run K2: {row}")
        check_card_decode(f"duplex {label}", launches, row["frames_displayed"])
        if extra and not row["echo_cancellation_active"]:
            raise RuntimeError(f"duplex {label}: echo cancellation was not set up")
        out[label] = row
    return out


def preview_thumbnails(dev):
    """(e) a 1080p60 sender with ``-F preview``: the preview display's RGB
    frames (960x540) on its unix socket, read by ``IpcFrameReader`` and
    written by ``write_thumbnail`` on the card (K1's RGB template at
    960x544) on a thread of this process; each thumbnail byte-equal to the
    CPU encode of the same RGB frame, each frame one of the testcard's
    frames converted and downscaled."""
    import socket

    from ultragrid_tpu_torch.modules.ipc_display import DEFAULT_SCALE, IpcFrameReader, ipc_scale_factor
    from ultragrid_tpu_torch.ops import pixfmt
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.pipeline.sender import VideoSender
    from ultragrid_tpu_torch.tools.thumbnailgen import write_thumbnail
    from ultragrid_tpu_torch.types import Codec

    tmp = tempfile.mkdtemp(prefix="chip_smoke_preview_")
    path = os.path.join(tmp, "preview.sock")
    reader = IpcFrameReader(path)
    thumbs, errors = [], []

    def consume():
        try:
            reader.accept(timeout=30)
            while len(thumbs) < THUMBNAILS:
                got = reader.read_frame(timeout=30)
                if got is None:
                    return
                w, h, color, data = got
                fn = os.path.join(tmp, f"thumb_{len(thumbs):06d}.jpg")
                write_thumbnail(w, h, data, fn, device=dev)
                with open(fn, "rb") as f:
                    thumbs.append((w, h, color, data, f.read()))
        except Exception as exc:  # noqa: BLE001 - raised below, in the phase's thread
            errors.append(exc)

    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 0))
    th = threading.Thread(target=consume, name="thumbnailgen", daemon=True)
    th.start()
    reset_kernel_counts()
    t0 = time.perf_counter()
    sender = VideoSender(LIVE_CAPTURE, "127.0.0.1", compress_spec="none", tx_port=sink.getsockname()[1],
                         mtu=9000, frame_limit=PREVIEW_FRAMES, capture_filter=f"preview:path={path}", device=dev)
    sender.run()
    th.join(timeout=60)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = kernel_counts()
    sink.close()
    reader.close()
    if errors or len(thumbs) < THUMBNAILS or th.is_alive():
        raise RuntimeError(f"preview: {len(thumbs)} thumbnails, errors {errors}")
    sc = ipc_scale_factor(W1080, H1080, *DEFAULT_SCALE)
    ring = [pixfmt.convert_frame(f, W1080, Codec.UYVY, Codec.RGB).view(H1080, W1080, 3)[::sc, ::sc]
            .contiguous().cpu().numpy().tobytes() for f in sender.capture.frames]
    for i, (w, h, color, data, jpg) in enumerate(thumbs):
        if (w, h, color) != (W1080 // sc, H1080 // sc, Codec.RGB) or data not in ring:
            raise RuntimeError(f"preview: frame {i} ({w}x{h} {color}) is no testcard frame scaled by 1/{sc}")
        fn = os.path.join(tmp, "cpu.jpg")
        write_thumbnail(w, h, data, fn, device="cpu")
        with open(fn, "rb") as f:
            if f.read() != jpg:
                raise RuntimeError(f"preview: thumbnail {i} differs from the CPU encode of its frame")
    if launches["jpeg_encode"] < THUMBNAILS:
        raise RuntimeError(f"preview: K1 launches {launches}")
    w, h = thumbs[0][:2]
    pw, ph = (w + 15) & ~15, (h + 7) & ~7
    e = JpegEncoder(pw, ph, in_codec=Codec.RGB, quality=75)
    img = np.pad(np.frombuffer(thumbs[0][3], np.uint8).reshape(h, w, 3), ((0, ph - h), (0, pw - w), (0, 0)),
                 mode="edge")
    f_d = torch.as_tensor(img.reshape(ph, pw * 3)).to(dev)
    b, ops = k1_work(e)
    bms, by = bound_ms(b, ops)
    shutil.rmtree(tmp, ignore_errors=True)
    return {"sender": LIVE_CAPTURE + " -F preview", "frames_sent": sender.frames_sent, "thumbnails": len(thumbs),
            "geometry": f"{w}x{h} RGB -> {pw}x{ph} JPEG q75 4:4:4", "thumbnail_bytes": [len(t[4]) for t in thumbs],
            "byte_equal_to_cpu": True, "launches": launches, "seconds": wall,
            "k1_thumbnail_rgb": {"ms": cuda_ms(lambda: e._encode(f_d)),
                               "device_ms": kernel_device_ms(lambda: e._encode(f_d), "jpeg_encode_kernel"),
                               "plain_ms": cuda_ms(lambda: e.encode_plain(f_d), runs=PLAIN_RUNS, warmup=1),
                               "bound_ms": bms, "bound_by": by}}


def ihdtv_session(dev):
    """(f) ``-x ihdtv`` as a user runs it, in two processes: the receiver
    ``python -m ultragrid_tpu_torch -x ihdtv -d dump:<tmp> --frames 30`` (on
    the card; the dump display writes each frame it shows) and, once its
    sockets are up, the sender ``-x ihdtv -t <1080p60 testcard> --frames 30
    127.0.0.1`` through ``cli.main`` here: 1080p v210 (the testcard
    converted on the card) over the two UDP streams, ports 3000/3001 as in
    the reference; every frame shown byte-equal to one the sender sent.  The
    protocol has no FEC: the receiver has an interpreter of its own, so that
    the sender's does not hold its socket reads back."""
    import socket

    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.ops import pixfmt
    from ultragrid_tpu_torch.pipeline.ihdtv import DEFAULT_PORTS
    from ultragrid_tpu_torch.types import Codec

    def bound(port):
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.bind(("", port))
            return False
        except OSError:
            return True
        finally:
            s.close()

    if any(bound(p) for p in DEFAULT_PORTS):
        raise RuntimeError(f"ihdtv: UDP port {DEFAULT_PORTS} taken on this machine")
    dev_args = [] if torch.device(dev).type == "cuda" else ["--device", "cpu"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ihdtv_")
    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=ROOT)
    rx = subprocess.Popen([sys.executable, "-m", "ultragrid_tpu_torch", "-x", "ihdtv", "-d", f"dump:{tmp}",
                           "--frames", str(IHDTV_FRAMES), *dev_args], cwd=ROOT, env=env,
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.monotonic()
        while not all(bound(p) for p in DEFAULT_PORTS):
            if rx.poll() is not None or time.monotonic() - t0 > 120:
                rx.kill()
                raise RuntimeError(f"ihdtv: the receiver did not come up: {rx.communicate()[0][-2000:]}")
            time.sleep(0.05)
        t_tx = time.perf_counter()
        rc_tx = cli_logged(["-x", "ihdtv", "-t", LIVE_CAPTURE, "--frames", str(IHDTV_FRAMES), "127.0.0.1", *dev_args])[0]
        tx_s = time.perf_counter() - t_tx
        out, _ = rx.communicate(timeout=60)
    finally:
        if rx.poll() is None:
            rx.kill()
            rx.wait()
    files = sorted(os.listdir(tmp))
    if rc_tx != 0 or rx.returncode != 0 or f"{IHDTV_FRAMES} frames shown (ihdtv)" not in out:
        raise RuntimeError(f"ihdtv: sender rc {rc_tx}, receiver rc {rx.returncode}, {len(files)} frames dumped: "
                           f"{out[-2000:]}")
    sent = {pixfmt.convert_frame(f, W1080, Codec.UYVY, Codec.v210).cpu().numpy().tobytes()
            for f in initialize_video_capture(LIVE_CAPTURE, device=dev).frames}
    paths = [os.path.join(tmp, f) for f in files]
    differing = 0
    for path in paths:
        with open(path, "rb") as fh:
            differing += fh.read() not in sent
    times = sorted(os.path.getmtime(p) for p in paths)
    shutil.rmtree(tmp, ignore_errors=True)
    if differing or len(paths) != IHDTV_FRAMES:
        raise RuntimeError(f"ihdtv: {differing} of {len(paths)} frames shown not byte-equal to a sent one")
    return {"frames_sent": IHDTV_FRAMES, "frames_received": len(paths), "byte_equal_to_sent": True,
            "bytes_per_frame": W1080 * H1080 * 8 // 3, "sender_frames_per_s": IHDTV_FRAMES / tx_s,
            "receiver_frames_per_s": (len(times) - 1) / (times[-1] - times[0]), "seconds": tx_s}


def phase_standards(dev):
    """This slice's paths at 1080p, the widest RFC 2435 carries: (a) the
    standards-mode session, (b) an RTSP sender and the port's RTSP capture,
    (c) RTSP capture of an H.264 camera stream at 15 frames/s and (c') the
    same at 30, every access unit decoded, (d) full-duplex calls through
    the CLI, (e) the preview socket and thumbnailgen, (f) iHDTV."""
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame

    t_phase = time.perf_counter()
    cpu_decode = CpuJpegDecodes()
    out = {"phase": "standards"}
    # the card's first JPEG encode and decode in this process (the CUDA
    # libraries' set-up), before any session
    ring = initialize_video_capture(LIVE_CAPTURE, device=dev).frames
    JpegDecompress(device=dev).decompress(
        VideoFrame(VideoDesc(W1080, H1080, Codec.JPEG, 60.0), [JpegEncoder(W1080, H1080).encode(ring[0])]), Codec.UYVY)
    torch.cuda.synchronize()
    h264_stream = rtsp_h264_stream(dev)
    # each row with the UDP datagrams the kernel dropped for full receive
    # buffers while it ran (any socket of this machine)
    for key, row in (("standards_session", lambda: standards_session(dev, cpu_decode)),
                     ("rtsp_jpeg", lambda: rtsp_jpeg_capture(dev, cpu_decode)),
                     ("rtsp_h264", lambda: rtsp_h264_capture(dev, h264_stream, RTSP_H264_FPS, every=False)),
                     ("rtsp_h264_30fps", lambda: rtsp_h264_capture(dev, h264_stream, RTSP_H264_FPS_FAST, every=True)),
                     ("duplex", lambda: duplex_calls(dev)),
                     ("preview", lambda: preview_thumbnails(dev)), ("ihdtv", lambda: ihdtv_session(dev))):
        drops = udp_rcvbuf_errors()
        out[key] = row()
        out[key]["udp_rcvbuf_errors"] = udp_rcvbuf_errors() - drops
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- phase parallel: the multi-device path ----

# 8K UHD, the reference's top resolution, as 4 row bands of 7680x1080 on one
# card (the reference's tiled mode round-robins tiles over the CUDA devices
# of one process; with one card every band sits on it)
PAR_W, PAR_H, PAR_BANDS = 7680, 4320, 4
PAR_H264 = (1920, 1080)  # 68 macroblock rows split over 4 bands (8K's 270 do not)
PAR_FILE_FRAMES = 3


def par_diff(a, b, what: str):
    """(differing bytes, largest difference) of two uint8 frames; raises
    beyond the decoder's stated tolerance (the card's float32 product is
    torch.matmul)."""
    nd, mx = byte_diff(a, b)
    if a.shape != b.shape or mx > 1 or nd > MAX_DIFF_BYTE_SHARE * a.numel():
        raise RuntimeError(f"parallel {what}: {nd} bytes differ (max {mx}), shapes {a.shape} {b.shape}")
    return {"bytes_differing": nd, "max_abs_err": mx}


def par_file_io(dev, tmp: str):
    """1080p raw ``file`` capture on the card, its frames through the
    ``y4m`` display and back through the ``file`` capture as I420, and
    ``swmix``, each against the file's bytes or the CPU."""
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.modules.video_display import initialize_video_display
    from ultragrid_tpu_torch.ops.planar import uyvy_to_i420
    from ultragrid_tpu_torch.types import Codec, VideoDesc

    frames = np.stack([content(H1080, 2 * W1080, 40 + i) for i in range(PAR_FILE_FRAMES)])
    raw = os.path.join(tmp, "frames.uyvy")
    with open(raw, "wb") as fh:
        fh.write(frames.tobytes())
    y4m = os.path.join(tmp, "frames.y4m")
    cap = initialize_video_capture(f"file:{raw}:{W1080}x{H1080}:60:UYVY", device=dev)
    disp = initialize_video_display(f"y4m:{y4m}", device=dev)
    disp.reconfigure(VideoDesc(W1080, H1080, Codec.UYVY, 60.0))
    t0 = time.perf_counter()
    for i in range(PAR_FILE_FRAMES):
        f, _ = cap.grab()
        if not f.data.is_cuda or not np.array_equal(f.data.cpu().numpy(), frames[i]):
            raise RuntimeError(f"parallel file capture: frame {i} is not the file's on the card")
        disp.put_frame(f)
    read_ms = (time.perf_counter() - t0) * 1e3 / PAR_FILE_FRAMES
    if cap.grab() != (None, None):
        raise RuntimeError("parallel file capture: a frame past the file's end")
    cap.done()
    disp.done()
    back = initialize_video_capture(f"file:{y4m}", device=dev)
    for i in range(PAR_FILE_FRAMES):
        f, _ = back.grab()
        want = uyvy_to_i420(torch.as_tensor(frames[i]), W1080, H1080)
        if not f.data.is_cuda or not torch.equal(f.data.cpu(), want):
            raise RuntimeError(f"parallel y4m round trip: frame {i} differs from the CPU's I420")
    back.done()
    spec = f"swmix:{W1080}:{H1080}:60#testcard:s={W1080}x{H1080}:c=UYVY#testcard:s=1280x720:c=RGB:pattern=gradient"
    mixed = []
    for where in (dev, "cpu"):
        mix = initialize_video_capture(spec, device=where)
        mixed.append(mix.grab()[0].data)
        mix.done()
    if not mixed[0].is_cuda or not torch.equal(mixed[0].cpu(), mixed[1]):
        raise RuntimeError("parallel swmix: the card's frame differs from the CPU's")
    return {"frames": PAR_FILE_FRAMES, "geometry": f"{W1080}x{H1080} UYVY", "on_card_equal_to_file": True,
            "y4m_round_trip_equal": True, "swmix_equal_to_cpu": True, "read_upload_ms_per_frame": read_ms}


def complete_profiles(fn, expect: dict, want: int = 5, attempts: int = 30):
    """Device time and launches of one call of fn(), read from profiles of
    single calls in which the profiler kept every launch of the kernels
    named in ``expect`` (name -> launches a call): it drops events now and
    then, of one kernel and not another, but never adds one.  Each profile
    traces a warm-up call first and keeps only the call after it (events
    launched just as tracing starts are the ones it loses).  No scaling by
    an anchor: the median call of up to ``want`` complete profiles.  Raises
    when no call shows the expected launches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    good = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        ks = kernel_table(prof, 1)
        seen = {name: sum(c for n, (c, _) in ks.items() if name in n) for name in expect}
        if seen == expect:
            good.append(ks)
            if len(good) == want:
                break
    if not good:
        raise RuntimeError(f"no profile of {attempts} single calls showed {expect} (last {seen})")
    good.sort(key=lambda p: sum(ms for _, ms in p.values()))
    ks = good[len(good) // 2]
    return {"device_ms": sum(ms for _, ms in ks.values()), "device_launches": sum(c for c, _ in ks.values()),
            "profiler_launches_per_call": expect, "complete_profiles": len(good),
            "device_ms_of_each": [sum(ms for _, ms in p.values()) for p in good],
            "kernels_per_call": {n[:60]: [c, ms] for n, (c, ms) in ks.items()}}


BANDED_FRAMES = 120
BANDED_CAPTURE = "testcard:s=7680x4320:f=10:c=UYVY"  # about the 8K link's rate on a host whose loopback UDP is slow
BANDED_KEEP_EVERY = 20  # shown frames kept and checked


ASSEMBLE_FRAMES = 60  # frames of the one-card 1080p60 JPEG + LDGM session of phase assemble


def assemble_case(dev, w, h, q, ri=None, first_segment=0, seed=1):
    """One geometry of the entropy assembly on the card: K1's slots of a
    content frame assembled by the kernel (its first segment
    ``first_segment``) against the host C assembly of the same slots (its
    markers counted on and the marker before the first segment added, as a
    band of a frame), and the files of ``JpegEncoder.encode_file`` and
    ``JpegEncoder.encode`` against the C assembly's; the kernels' device
    time against their bound
    (the slots' used words and the bit counts read once, the body written
    once)."""
    from ultragrid_tpu_torch.ops import jpeg_assemble_cuda
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize

    enc = JpegEncoder(w, h, quality=q, restart_interval=ri)
    fr = torch.as_tensor(content(h, vc_get_linesize(w, Codec.UYVY), seed)).to(dev)
    parts = enc._encode(fr)
    if bool(parts[-1]):
        raise RuntimeError(f"assembly {w}x{h} q{q}: K1 overflowed at {enc.wwords} words")
    c_body = enc.assemble(*parts[:-1])
    want = c_body.copy()
    if first_segment:
        ff = np.flatnonzero(want[:-1] == 0xFF) + 1
        at = ff[(want[ff] & 0xF8) == 0xD0]
        want[at] = 0xD0 | ((want[at] + first_segment % 8) & 7)
        want = np.concatenate([np.array([0xFF, 0xD0 + (first_segment - 1) % 8], np.uint8), want])

    def run():
        asm = jpeg_assemble_cuda.Assembly(parts, ky=enc.ky, restart_interval=enc.restart_interval,
                                          first_segment=first_segment)
        _, n = asm.read()
        out = torch.empty(n, dtype=torch.uint8, device=dev)
        asm.write(out)
        return out

    got = run().cpu().numpy()
    if not np.array_equal(got, want):
        diff = np.flatnonzero(got[: min(got.size, want.size)] != want[: min(got.size, want.size)])
        raise RuntimeError(f"assembly {w}x{h} q{q} ri{enc.restart_interval} first {first_segment}: "
                           f"{got.size} bytes against the C path's {want.size}, first difference at "
                           f"{diff[:1].tolist()}")
    label = f"{w}x{h} q{q} ri{enc.restart_interval}" + (f" from segment {first_segment}" if first_segment else "")
    row = {"what": f"jpeg_assemble {label}", "bytes": int(got.size), "segments": enc.nseg,
           "ff_bytes": int((c_body == 0xFF).sum()), "equal_to_c": True}
    if not first_segment:
        c_file = jpeg_file(enc, parts)
        if not (np.array_equal(np.asarray(enc.encode_file(fr)), c_file) and np.array_equal(enc.encode(fr), c_file)):
            raise RuntimeError(f"assembly {label}: encode_file or encode differs from the C assembly's file")
        row["file_and_encode_equal_to_c"] = True
    ks = device_kernels(run, runs=20, expect="jpeg_assemble")
    mine = {k: v for k, v in ks.items() if "jpeg_assemble" in k}
    if len(mine) != 3:
        raise RuntimeError(f"assembly {label}: the profiler saw {sorted(ks)}")
    dev_ms = sum(ms for _, ms in mine.values())
    words = sum(int(torch.minimum((b.long() + 31) // 32, torch.tensor(enc.wwords, device=dev)).sum())
                for b in parts[1:6:2])
    nbytes = 4 * words + 4 * enc.nblocks + got.size  # used slot words and bit counts read, body written
    bound, what = bound_ms(nbytes, 0)
    plain = cuda_ms(lambda: jpeg_assemble_cuda.assemble_plain(*parts[:-1], ky=enc.ky,
                                                               restart_interval=enc.restart_interval,
                                                               first_segment=first_segment),
                    runs=PLAIN_RUNS, warmup=1)
    row.update(device_ms=dev_ms, kernels={k: v[1] for k, v in mine.items()}, bound_ms=bound, bound_by=what,
               share_of_bound=bound / dev_ms, host_ms_read_and_write=host_ms(lambda: run(), 20),
               plain_ms=plain)
    return row


def phase_assemble(dev):
    """The entropy assembly on the card and the LDGM buffer built on the
    card (this phase alone: ``--only assemble``).  The assembly kernel
    against the host C assembly at 1080p and 4K at q80 and q95 and on an 8K
    band (7680x1080, restart interval 32, as the third band of four:
    markers numbered from segment 4050); an escalation forced on a noise
    frame (slots of 2 words at q95) against the CPU's file and the C
    assembly's;
    ``LdgmSession.encode_tensor`` of a file on the card against
    ``LdgmSession.encode`` on the host at 1080p and 8K sizes; and the
    1080p60 JPEG + LDGM session on one card: every frame's file assembled
    on the card (one assembly a frame sent) and its LDGM buffer built on
    the card (``Tx.fec_routes``), none on the host, every file sent the
    C path's encode of its capture."""
    from ultragrid_tpu_torch.ops import jpeg_assemble_cuda
    from ultragrid_tpu_torch.ops.fec import LdgmSession
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize

    out = {"phase": "assemble", "cases": []}
    for w, h, q, ri, first in ((W1080, H1080, 80, None, 0), (W1080, H1080, 95, None, 0),
                               (W4K, H4K, 80, None, 0), (W4K, H4K, 95, None, 0),
                               (7680, 1080, 80, 32, 2 * 2025), (7680, 1080, 95, 32, 2 * 2025),
                               (W1080, H1080, 80, 1, 0), (W1080, H1080, 80, 7, 5)):
        out["cases"].append(assemble_case(dev, w, h, q, ri, first))
    # an escalation: slots of 2 words cannot hold noise at q95
    noise = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (64, 512), dtype=np.uint8)).to(dev)
    card, cpu = JpegEncoder(256, 64, quality=95), JpegEncoder(256, 64, quality=95)
    card.wwords = cpu.wwords = 2
    c_enc = JpegEncoder(256, 64, quality=95)
    c_enc.wwords = 2
    file = np.asarray(card.encode_file(noise))
    want, c_file = cpu.encode(noise.cpu(), device="cpu"), c_path_file(c_enc, noise)
    if (card.wwords != cpu.wwords or card.wwords != c_enc.wwords or card.wwords <= 2
            or not np.array_equal(file, want) or not np.array_equal(file, c_file)):
        raise RuntimeError(f"assembly escalation: {card.wwords} / {cpu.wwords} / {c_enc.wwords} words, files "
                           f"equal {np.array_equal(file, want)} / {np.array_equal(file, c_file)}")
    out["escalation"] = {"wwords": card.wwords, "file_bytes": int(file.size), "equal_to_cpu": True,
                         "equal_to_c_assembly": True}
    # the LDGM buffer on the card
    sess = LdgmSession(256, 26, 5)
    hdr = bytes(range(24))
    rows = []
    for w, h in ((W1080, H1080), (7680, 4320)):
        enc = JpegEncoder(w, h)
        f = enc.encode_file(torch.as_tensor(content(h, vc_get_linesize(w, Codec.UYVY), 2)).to(dev))
        buf, fd = sess.encode_tensor(f, hdr=hdr)
        host, hd = sess.encode(np.concatenate([np.frombuffer(hdr, np.uint8), np.asarray(f)]))
        if fd != hd or not np.array_equal(buf.cpu().numpy(), host):
            raise RuntimeError(f"LDGM buffer on the card {w}x{h}: differs from the host's")
        ms_card = host_ms(lambda: (sess.encode_tensor(f, hdr=hdr)[0].cpu()), 20)
        f_host = np.asarray(f)
        ms_host = host_ms(lambda: sess.encode(np.concatenate([np.frombuffer(hdr, np.uint8), f_host])), 20)
        rows.append({"what": f"LDGM buffer {w}x{h}", "file_bytes": int(f.numel()), "buffer_bytes": int(host.size),
                     "equal_to_host": True, "host_ms_card_and_download": ms_card, "host_ms_host_c": ms_host})
    out["ldgm_buffer"] = rows
    # the 1080p60 session on one card
    files, packets = {}, []
    held = {}

    def tap(sender):
        tap_sent_files(sender, files, packets)
        held["sender"] = sender

    row, _, sender = live_run(dev, LIVE_CAPTURE, "jpeg:80", FEC, ASSEMBLE_FRAMES, tap=tap)
    routes = dict(sender.tx.fec_routes)
    la = row["launches"]
    if (routes != {"card": row["frames_sent"], "host": 0} or la["jpeg_assemble"] != row["frames_sent"]
            or la["jpeg_encode"] != row["frames_sent"]):
        raise RuntimeError(f"assembly session: routes {routes}, launches {la}, {row['frames_sent']} frames sent")
    enc = next(iter(sender.compress.impl._encoders.values()))
    ring = {c_path_file(JpegEncoder(W1080, H1080, quality=80, restart_interval=enc.restart_interval), f).tobytes()
            for f in sender.capture.frames}
    if not files or any(v not in ring for v in files.values()):
        raise RuntimeError(f"assembly session: a sent file is not the C path's encode of a capture")
    if row["frames_displayed"] < row["frames_sent"] // 2 or row["frames_off_card"]:
        raise RuntimeError(f"assembly session: {row}")
    check_card_decode("assembly session", la, row["frames_displayed"])
    row.update(fec_routes=routes, files_checked=len(files))
    out["session"] = row
    out["launches"] = {"jpeg_assemble": jpeg_assemble_cuda.LAUNCHES.count}
    return out


def banded_session(dev):
    """The 8K JPEG + LDGM live session split by row band over four cards
    (``--param cuda-device=0,1,2,3``) through VideoSender and VideoReceiver:
    K1 launched once a card and frame sent, the decode launched once a card
    and frame shown and never refused, the files sent byte-equal to the
    one-card encode of their capture at the bands' restart interval (every
    ``BANDED_KEEP_EVERY``-th), and the frames shown bit-equal to the
    one-card decode of their file."""
    from ultragrid_tpu_torch.ops import jpeg_assemble_cuda, jpeg_cuda, jpeg_decode_cuda
    from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, JpegEncoder
    from ultragrid_tpu_torch.parallel.sharded_jpeg import ShardedJpegEncoder
    from ultragrid_tpu_torch.utils import params

    files, packets, shown = {}, [], []
    held = {}

    def tap(sender):
        tap_sent_files(sender, files, packets)
        held["sender"] = sender

    def on_shown(frame):
        if len(shown) % BANDED_KEEP_EVERY == 0:
            shown.append((int(round(frame.timestamp * 90000)) & 0xFFFFFFFF, frame.data.clone()))
        else:
            shown.append(None)

    # the param is process-wide: the phases after this one drive the one-card path
    saved = dict(params._values)
    params.set_commandline_param("cuda-device", ",".join(str(i) for i in range(PAR_BANDS)))
    try:
        row, _, sender = live_run(dev, BANDED_CAPTURE, "jpeg:80", FEC, BANDED_FRAMES, tap=tap,
                                  on_shown=on_shown, grace_s=10.0, idle_s=5.0)
    finally:
        params._values.clear()
        params._values.update(saved)
    k1 = dict(jpeg_cuda.LAUNCHES.per_device)
    assembled = dict(jpeg_assemble_cuda.LAUNCHES.per_device)
    dec = dict(jpeg_decode_cuda.LAUNCHES.per_device)
    refused = jpeg_decode_cuda.REFUSED.count
    routes = dict(sender.tx.fec_routes)
    enc = next(e for e in sender.compress.impl._encoders.values())
    if not isinstance(enc, ShardedJpegEncoder) or [d.index for d in enc.devices] != list(range(PAR_BANDS)):
        raise RuntimeError(f"banded session: the sender's encoder is {type(enc).__name__}")
    want = {i: row["frames_sent"] for i in range(PAR_BANDS)}
    if k1 != want or assembled != want:
        raise RuntimeError(f"banded session: K1 launches per card {k1}, assemblies {assembled}, want one a card "
                           f"and frame sent {want}")
    if routes != {"card": row["frames_sent"], "host": 0}:
        raise RuntimeError(f"banded session: LDGM buffers built {routes}, want every one on the card")
    want = {i: row["frames_displayed"] for i in range(PAR_BANDS)}
    if dec != want or refused:
        raise RuntimeError(f"banded session: decode launches per card {dec}, want {want}; refused {refused}")
    ri = enc.local.restart_interval
    one = JpegEncoder(PAR_W, PAR_H, quality=80, restart_interval=ri)
    ring = {c_path_file(one, f).tobytes() for f in sender.capture.frames}
    keys = sorted(files)
    sampled = keys[::BANDED_KEEP_EVERY]
    if not sampled or any(files[k_] not in ring for k_ in sampled):
        raise RuntimeError(f"banded session: a sent file is not the one-card encode of a capture ({len(files)} sent)")
    single = JpegDecoder(dev)
    checked = 0
    for key, pic in (x for x in shown if x is not None):
        if key not in files or not torch.equal(pic, single.decode_to_uyvy(files[key])[0]):
            raise RuntimeError(f"banded session: the frame shown under {key} is not the one-card decode of its file")
        checked += 1
    if row["frames_displayed"] < row["frames_sent"] // 2 or row["frames_off_card"] or not checked:
        raise RuntimeError(f"banded session: {row}")
    row.update(k1_launches_per_card=k1, assembly_launches_per_card=assembled, fec_routes=routes,
               decode_launches_per_card=dec, decode_refused=refused,
               restart_interval=ri, segments_per_band=enc.local.nseg, files_checked=len(sampled),
               shown_frames_checked=checked, file_bytes_mean=float(np.mean([len(f) for f in files.values()])))
    return row


def phase_parallel(dev):
    """This slice's path on the card: the multi-device steps over a mesh of
    four row bands on one card at 8K UYVY (7680x4320, bands of 7680x1080):
    the sender step (per band K1, then K2 over the band's slot container,
    LDGM 256:26:5) against single-band encodes and K2's plain version and
    against the CPU port; the receiver step with one data symbol erased per
    band (the peel on the card, the band-local C scan decode, the reverse
    product per band) against the CPU plain path and the unsharded decode;
    ShardedJpegDecoder; the halo deinterlace; sharded H.264 at 1080p x 4;
    the dry run; the file modules.  Times the 8K x 4 sender step beside the
    unsharded 8K step, and the receiver's stages."""
    from ultragrid_tpu_torch.models.encode import EncodeConfig, EncodePipeline
    from ultragrid_tpu_torch.ops import postprocess
    from ultragrid_tpu_torch.ops.h264_dec import IntraDecoder
    from ultragrid_tpu_torch.ops.h264_fast import FastStreamDecoder
    from ultragrid_tpu_torch.ops.jpeg import JpegDecoder, JpegEncoder
    from ultragrid_tpu_torch.parallel import make_mesh, shard_frame_rows
    from ultragrid_tpu_torch.parallel.dryrun import dryrun_multichip
    from ultragrid_tpu_torch.parallel.sharded_h264 import ShardedH264Encoder
    from ultragrid_tpu_torch.parallel.sharded_jpeg import (ShardedJpegDecoder, ShardedReceiverStep,
                                                           ShardedSenderStep, band_symbols)
    from ultragrid_tpu_torch.parallel.sharded_post import sharded_deinterlace
    from ultragrid_tpu_torch.types import Codec, VideoDesc

    t_phase = time.perf_counter()
    out = {"phase": "parallel", "geometry": f"{PAR_W}x{PAR_H} UYVY q80, {PAR_BANDS} row bands of "
                                            f"{PAR_W}x{PAR_H // PAR_BANDS} on one card", "fec": FEC}
    mesh = make_mesh(devices=[dev] * PAR_BANDS)
    cpu_mesh = make_mesh(PAR_BANDS, device="cpu")
    k, m, c = 256, 26, 5
    frame_np = content(PAR_H, 2 * PAR_W, 31)
    frame = torch.as_tensor(frame_np).to(dev)
    bands = shard_frame_rows(frame, mesh)
    step = ShardedSenderStep(PAR_W, PAR_H, mesh, quality=80, k=k, m=m, c=c)
    rx = ShardedReceiverStep(PAR_W, PAR_H, mesh, quality=80, k=k, m=m, c=c, wwords=step.base.local.wwords)
    step(bands)  # the card's first launches at these shapes
    torch.cuda.synchronize()

    # ---- the sender step, counted ----
    reset_kernel_counts()
    outs = step(bands)
    torch.cuda.synchronize()
    sender_l = kernel_counts()
    if sender_l["jpeg_encode"] != PAR_BANDS or sender_l["gf2_parity"] != PAR_BANDS:
        raise RuntimeError(f"parallel sender step: launches {sender_l}, expected {PAR_BANDS} of K1 and of K2")
    if any(bool(o[7]) for o in outs) or not all(t.is_cuda for o in outs for t in o):
        raise RuntimeError("parallel sender step: overflow, or an output off the card")
    # each band against a single-band encode (K1) plus K2's plain version
    single = JpegEncoder(PAR_W, PAR_H // PAR_BANDS, quality=80, restart_interval=step.base.local.restart_interval)
    for s, (band, o) in enumerate(zip(bands, outs)):
        want = single._encode(band)
        if not all(torch.equal(a, b) for a, b in zip(o[:6], want[:6])):
            raise RuntimeError(f"parallel sender step: band {s}'s slots differ from a single-band encode")
        plain = step.parity.plain(*want[:6]).view(torch.uint8).reshape(m, step.ps)
        if not torch.equal(o[6], plain):
            raise RuntimeError(f"parallel sender step: band {s}'s parity differs from K2's plain version")
    t0 = time.perf_counter()
    cpu_outs = ShardedSenderStep(PAR_W, PAR_H, cpu_mesh, quality=80, k=k, m=m, c=c)(frame_np)
    cpu_s = time.perf_counter() - t0
    for s, (o, co) in enumerate(zip(outs, cpu_outs)):
        if not all(torch.equal(a.cpu(), b) for a, b in zip(o[:7], co[:7])):
            raise RuntimeError(f"parallel sender step: band {s} differs from the CPU port's")
    out["sender"] = {"launches": sender_l, "bands_equal_single_band_plus_k2_plain": True,
                     "bands_equal_cpu": True, "cpu_plain_seconds": cpu_s, "ps": step.ps,
                     "row_counts": step.row_counts, "wwords": step.base.local.wwords,
                     "restart_interval": step.base.local.restart_interval}

    # ---- the receiver step, one data symbol erased per band, counted ----
    sym = np.stack([band_symbols(o, step.row_counts, step.ps, k) for o in outs])
    lost = np.random.default_rng(32).integers(0, sum(step.row_counts), PAR_BANDS)
    present = np.ones(sym.shape[:2], bool)
    present[np.arange(PAR_BANDS), lost] = False
    lossy = sym.copy()
    lossy[~present] = 0
    rx(lossy, present)  # warm-up
    torch.cuda.synchronize()
    reset_kernel_counts()
    rx_bands, ok = rx(lossy, present)
    torch.cuda.synchronize()
    receiver_l = kernel_counts()
    if not ok.all() or not all(b.is_cuda for b in rx_bands):
        raise RuntimeError(f"parallel receiver step: ok {ok.tolist()}, or a band off the card")
    if receiver_l["gf2_parity"] != sum(rx.rounds) or min(rx.rounds) < 1 or receiver_l["jpeg_encode"]:
        raise RuntimeError(f"parallel receiver step: K2 {receiver_l['gf2_parity']}, peel rounds {rx.rounds}")
    got = torch.cat(rx_bands)
    cpu_bands, cpu_ok = ShardedReceiverStep(PAR_W, PAR_H, cpu_mesh, quality=80, k=k, m=m, c=c,
                                            wwords=step.base.local.wwords)(lossy, present)
    if not cpu_ok.all():
        raise RuntimeError("parallel receiver step: the CPU plain path recovered fewer bands")
    vs_cpu = par_diff(got, torch.cat(cpu_bands), "receiver step against the CPU plain path")
    jfile = step.base.encode(bands).tobytes()
    whole = JpegDecoder(dev).decode_to_uyvy(jfile)[0]
    vs_whole = par_diff(got, whole, "receiver step against the unsharded 8K decode")
    out["receiver"] = {"launches": receiver_l, "peel_rounds": rx.rounds, "lost_rows": lost.tolist(),
                       "ok": ok.tolist(), "against_cpu": vs_cpu, "against_unsharded_decode": vs_whole,
                       "file_bytes": len(jfile)}

    # ---- ShardedJpegDecoder, the halo deinterlace, H.264, the dry run, files ----
    dec_bands, dh, dw = ShardedJpegDecoder(mesh).decode_to_uyvy(jfile)
    if (dh, dw) != (PAR_H, PAR_W) or len(dec_bands) != PAR_BANDS:
        raise RuntimeError(f"parallel ShardedJpegDecoder: {len(dec_bands)} bands of {dh}x{dw}")
    out["sharded_decoder"] = par_diff(torch.cat(dec_bands), whole, "ShardedJpegDecoder against JpegDecoder")
    for kind, fn in (("blend", postprocess.deinterlace_blend), ("linear", postprocess.deinterlace_linear)):
        di = sharded_deinterlace(frame, Codec.UYVY, mesh, kind=kind)
        if not all(b.is_cuda for b in di) or not torch.equal(torch.cat(di), fn(frame, Codec.UYVY)):
            raise RuntimeError(f"parallel deinterlace {kind}: differs from ops/postprocess on the whole frame")
    out["deinterlace"] = {"kinds": ["blend", "linear"], "byte_equal": True}
    hw, hh = PAR_H264
    h_np = content(hh, 2 * hw, 33)
    henc = ShardedH264Encoder(hw, hh, mesh, qp=26)
    au = henc.encode(torch.as_tensor(h_np).to(dev))
    if au != ShardedH264Encoder(hw, hh, cpu_mesh, qp=26).encode(h_np):
        raise RuntimeError("parallel h264: the card's access unit differs from the CPU port's")
    t0 = time.perf_counter()
    pic = FastStreamDecoder().decode_au(au)
    c_ms = (time.perf_counter() - t0) * 1e3
    ref_pic = IntraDecoder().decode(au)
    if pic is None or not all(np.array_equal(a, b) for a, b in zip(pic, ref_pic)):
        raise RuntimeError("parallel h264: the C decoder's picture is not the encoder's reference picture")
    out["h264"] = {"geometry": f"{hw}x{hh} UYVY qp 26, {PAR_BANDS} slices", "au_bytes": len(au),
                   "wwords": henc.wwords, "equal_to_cpu": True, "c_decode_equal_to_reference_picture": True,
                   "c_decode_ms": c_ms}
    dryrun_multichip(PAR_BANDS, devices=[dev] * PAR_BANDS)
    out["dryrun"] = {"devices": f"[{dev}] x {PAR_BANDS}", "asserts_held": True}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_file_io_")
    try:
        out["file_io"] = par_file_io(dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- timing: the sharded sender step beside the unsharded 8K step ----
    # both rows read one way: single-call profiles that show every launch
    whole_pipe = EncodePipeline(VideoDesc(PAR_W, PAR_H, Codec.UYVY, 60.0), EncodeConfig(compress="jpeg", fec=FEC),
                                device=dev)
    out["timing"] = {"card": nvidia_smi_line()}
    for row, fn, n in (("sharded_sender", lambda: step(bands), PAR_BANDS), ("unsharded_sender",
                                                                             lambda: whole_pipe(frame), 1)):
        out["timing"][row] = {**complete_profiles(fn, {"jpeg_encode_kernel": n, "gf2_parity_kernel": n}),
                              "ms": cuda_ms(fn, runs=20),
                              "host_ms": host_ms(lambda: (fn(), torch.cuda.synchronize()), runs=20)}
    t = {"peel": [], "host_decode": [], "device_decode": [], "upload": []}
    for _ in range(5):
        t0 = time.perf_counter()
        peeled = rx.peel(lossy, present)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hdr, nmcux, nmcuy, coeffs, _ = rx.host_decode(peeled)
        t2 = time.perf_counter()
        rx.device_decode(hdr, nmcux, nmcuy, coeffs)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for cf in coeffs:
            for o in cf:
                torch.as_tensor(o, device=dev)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, a, b in (("peel", t0, t1), ("host_decode", t1, t2), ("device_decode", t2, t3), ("upload", t3, t4)):
            t[key].append((b - a) * 1e3)
    # the host stage of one band, split: its copy to the host, the C
    # assembly of its stream, the C scan decode
    from ultragrid_tpu_torch.ops.jpeg import entropy_decode_422

    band0 = peeled[0][0][:k]
    rows = band0.cpu().numpy()
    stream = rx._assemble_band(rows)
    split = {"copy_ms": host_ms(lambda: band0.cpu(), runs=5),
             "assemble_ms": host_ms(lambda: rx._assemble_band(rows), runs=5),
             "scan_decode_ms": host_ms(lambda: entropy_decode_422(stream), runs=5)}
    out["timing"]["receiver"] = {
        **{f"{key}_ms": float(np.median(v)) for key, v in t.items()},
        **complete_profiles(lambda: rx(lossy, present), {"gf2_parity_kernel": sum(rx.rounds)}),
        "host_ms": host_ms(lambda: rx(lossy, present), runs=3),
        "host_decode_one_band": split,
        "note": "medians of 5 calls; device_decode_ms includes the upload; device_ms by the profiler, "
                "the median of single-call profiles showing every peel launch"}
    # K2 over one band's container: its bound from the bytes it must move,
    # beside its device time in the sharded step's profile (4 launches)
    b_k2, ops_k2 = k2_work(step.parity)
    bms, by = bound_ms(b_k2, ops_k2)
    k2_prof = [v for n, v in out["timing"]["sharded_sender"]["kernels_per_call"].items() if "gf2_parity" in n]
    band_ms = sum(ms for _, ms in k2_prof) / sum(c for c, _ in k2_prof)
    out["timing"]["k2_band"] = {"device_ms": band_ms, "bound_ms": bms, "bound_by": by,
                                "share_of_bound": bms / band_ms, "mbytes": b_k2 / 1e6, "xors": ops_k2}
    out["launches_sharded_sender"] = sender_l
    out["launches_sharded_receiver"] = receiver_l
    # ---- the banded live session over four cards, where four are present ----
    if torch.cuda.device_count() >= PAR_BANDS:
        out["banded_session"] = banded_session(dev)
    else:
        out["banded_session"] = f"not run: {torch.cuda.device_count()} card(s), {PAR_BANDS} needed"
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- the bench tools and the remaining captures ----

TOOLS_LATENCY = (1920, 1080, 60, 300)  # bench_latency's session: width, height, fps, frames
TOOLS_RECEIVER_FRAMES = 30
TOOLS_CAPTURE_FRAMES = 30
TOOLS_V4L2_FRAMES = 10


def counted(fn):
    """(fn(), every hand kernel's launches while it ran)."""
    reset_kernel_counts()
    r = fn()
    torch.cuda.synchronize()
    return r, kernel_counts()


def tools_bench_pipeline(dev):
    """bench_pipeline's ten rows on the card at the reference's sizes, K1 and
    K2 counted per row; the last call of each K1 row against its plain
    version on the card (slot words, the pipelined JPEG body, the 8K LDGM
    buffer rebuilt from ``encode_plain``)."""
    from ultragrid_tpu_torch.tools import bench_pipeline

    rows = {}
    by_config = {}
    for row in bench_pipeline.build_rows(dev):
        _, launches = counted(row.run)
        rows[row.config] = {"ms_per_frame": row.seconds * 1e3, "launches": launches}
        by_config[row.config] = row
        if (launches["jpeg_encode"] > 0) != (row.plain is not None) or launches["gf2_parity"]:
            raise RuntimeError(f"bench_pipeline {row.config!r}: launches {launches}")
    for config, row in by_config.items():
        if row.plain is None:
            continue
        plain = row.plain()
        if isinstance(plain, tuple):
            d = differing_blocks(row.last, plain)
            if d or bool(row.last[6]) != bool(plain[6]) or not row.last[0].is_cuda:
                raise RuntimeError(f"bench_pipeline {config!r}: {d} blocks differ from the plain version")
            rows[config]["differing_blocks_vs_plain"] = d
        else:
            if row.last.tobytes() != plain.tobytes():
                raise RuntimeError(f"bench_pipeline {config!r}: bytes differ from the plain version's")
            rows[config]["bytes_equal_plain"] = len(plain)
    return rows


def tools_captures(dev):
    """Screen capture from a mock X server at 1080p (card against CPU,
    upload ms), ``ug_input`` fed by a 1080p60 ``-c none`` sender, v4l2's
    probe (or frames), every hardware stub's message."""
    import glob

    from tests.torch_x11_mock import MockXServer
    from ultragrid_tpu_torch.modules import hw_stubs, screen_capture, ug_input
    from ultragrid_tpu_torch.modules.registry import LibraryClass, load_library
    from ultragrid_tpu_torch.modules.v4l2_capture import V4l2Capture
    from ultragrid_tpu_torch.modules.video_capture import TestcardCapture
    from ultragrid_tpu_torch.pipeline.sender import VideoSender

    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_x11_")
    rng = np.random.default_rng(12)
    alpha = rng.integers(0, 256, (32, 32)).astype(np.uint32)
    rgb = (rng.integers(0, 256, (32, 32, 3)) * alpha[..., None] // 255).astype(np.uint32)
    cursor = (900, 500, 32, 32, 4, 4, (alpha << 24) | (rgb[..., 0] << 16) | (rgb[..., 1] << 8) | rgb[..., 2])
    srv = MockXServer(os.path.join(tmp, "X0"), width=W1080, height=H1080, with_xfixes=True, cursor=cursor)
    try:
        cpu_cap = screen_capture.ScreenCapture(f"display={srv.path}", device="cpu")
        want = cpu_cap.grab()[0].data
        cpu_cap.done()
        cap = screen_capture.ScreenCapture(f"display={srv.path}", device=dev)
        grab_ms = []
        try:
            for i in range(TOOLS_CAPTURE_FRAMES):
                t0 = time.perf_counter()
                frame = cap.grab()[0]
                torch.cuda.synchronize()
                grab_ms.append((time.perf_counter() - t0) * 1e3)
                if frame is None or not frame.data.is_cuda or not torch.equal(frame.data.cpu(), want):
                    raise RuntimeError(f"screen capture: frame {i} is not the CPU capture's, on the card")
        finally:
            cap.done()
    finally:
        srv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    host = want.numpy()
    upload_ms = []
    for _ in range(TOOLS_CAPTURE_FRAMES):
        t0 = time.perf_counter()
        torch.from_numpy(host).to(dev)
        torch.cuda.synchronize()
        upload_ms.append((time.perf_counter() - t0) * 1e3)
    out["screen"] = {"geometry": f"{W1080}x{H1080} RGB, a 32x32 translucent cursor", "frames": TOOLS_CAPTURE_FRAMES,
                     "byte_equal_cpu": True, "grab_ms_median": float(np.median(grab_ms)),
                     "upload_ms_median": float(np.median(upload_ms)), "upload_ms_min": min(upload_ms),
                     "mbytes_a_frame": host.nbytes / 1e6}

    port = free_port_pair()
    spec = f"testcard:s={W1080}x{H1080}:f=60:c=UYVY:still=1"
    sent = TestcardCapture(spec.partition(":")[2], device=dev).grab()[0].data
    cap = ug_input.UgInputCapture(f"port={port}", device=dev)
    sender = VideoSender(spec, "127.0.0.1", compress_spec="none", tx_port=port, mtu=9000,
                         frame_limit=TOOLS_CAPTURE_FRAMES + 60, device=dev)
    t = threading.Thread(target=sender.run, daemon=True)
    t0 = time.perf_counter()
    t.start()
    try:
        # the first frame, wider than the receiver's first slots, is whole:
        # the port's C layer grows them before it scatters the frame (ROADMAP
        # F12, repaired in the port; the reference's shows zeros at its top)
        first = cap.grab()[0]
        if first is None or not first.data.is_cuda or first.data.shape != sent.shape:
            raise RuntimeError("ug_input: no first frame on the card")
        bad = (first.data != sent).any(1).nonzero().reshape(-1).tolist()
        if bad:
            raise RuntimeError(f"ug_input: the first frame differs from the testcard sent in {len(bad)} rows, "
                               f"from row {bad[0]}")
        for i in range(TOOLS_CAPTURE_FRAMES):
            frame = cap.grab()[0]
            if frame is None or not frame.data.is_cuda or not torch.equal(frame.data, sent):
                raise RuntimeError(f"ug_input: frame {i + 1} is not the testcard sent, on the card")
        seconds = time.perf_counter() - t0
    finally:
        sender.should_exit.set()
        t.join(timeout=20)
        cap.done()
    out["ug_input"] = {"sender": f"{spec} -c none, MTU 9000", "frames_equal_sent": TOOLS_CAPTURE_FRAMES + 1,
                       "first_frame_whole": True, "seconds_from_sender_start": seconds}

    devs = glob.glob("/dev/video*")
    if devs:
        cap = V4l2Capture("", device=dev)
        try:
            got = [cap.grab()[0] for _ in range(TOOLS_V4L2_FRAMES)]
        finally:
            cap.done()
        if any(f is None or not f.data.is_cuda for f in got):
            raise RuntimeError("v4l2: a frame missing or off the card")
        out["v4l2"] = {"devices": devs, "frames": len(got)}
    else:
        try:
            V4l2Capture("", device=dev)
        except RuntimeError as e:
            out["v4l2"] = {"devices": [], "probe": str(e)}
        else:
            raise RuntimeError("v4l2: a capture opened without a /dev/video device")
    stubs = {}
    for cls, names in ((LibraryClass.VIDEO_CAPTURE, ("decklink", "ndi", "aja")),
                       (LibraryClass.VIDEO_DISPLAY, ("decklink", "ndi", "sdl", "openxr_gl", "vulkan")),
                       (LibraryClass.AUDIO_CAPTURE, ("pipewire", "jack", "portaudio", "pulse", "coreaudio",
                                                     "wasapi", "sdi"))):
        for name in names:
            try:
                load_library(name, cls)("")
            except RuntimeError as e:
                if name not in str(e):
                    raise
                stubs[f"{cls.value}/{name}"] = str(e)
            else:
                raise RuntimeError(f"{cls.value}/{name}: the stub opened")
    if load_library("alsa", LibraryClass.AUDIO_CAPTURE).__name__ != "AlsaAudioCapture":
        raise RuntimeError("-s alsa no longer reaches audio/alsa.py")
    stubs["alsa (the stub's message, not registered)"] = hw_stubs._audio_probe_msg("alsa")
    out["stubs"] = stubs
    return out


def phase_tools(dev):
    """This slice's path on the card: the port's bench tools at the
    reference tools' own sizes (bench_pipeline's ten rows, bench_northstar at
    7680x2160, bench_jpeg_dev and bench_scan_decode at 4K, bench_h264_enc_dev
    at 1080p qp 26, bench_latency's two-process 1080p60 session of 300
    frames, bench_receiver for 30 frames), every kernel row against its plain
    version and every tool's output against the CPU port's; then the screen
    capture, ug_input, v4l2 and the hardware stubs.  K1 and K2 are counted
    per tool (the receiver child of bench_latency is uncounted)."""
    from ultragrid_tpu_torch.ops.h264_device import STOP_STAGES, make_device_encode_p
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.tools import (bench_h264_enc_dev, bench_jpeg_dev, bench_latency, bench_northstar,
                                           bench_receiver, bench_scan_decode)

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    out = {"phase": "tools", "card": nvidia_smi_line()}
    launches = {}
    seconds = {}

    t0 = time.perf_counter()
    out["bench_pipeline"] = tools_bench_pipeline(dev)
    launches["bench_pipeline"] = {k: sum(r["launches"][k] for r in out["bench_pipeline"].values())
                                  for k in ("jpeg_encode", "gf2_parity", "jpeg_decode")}
    seconds["bench_pipeline"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ns, launches["bench_northstar"] = counted(lambda: bench_northstar.run(W8K, H8K, 24, dev))
    pipe, frame = ns["pipe"], ns["frame"]
    step, step_l = counted(lambda: pipe(frame))
    if step_l["jpeg_encode"] != 1 or step_l["gf2_parity"] != 1:
        raise RuntimeError(f"bench_northstar: a step launched {step_l}, expected one K1 and one K2")
    plain = plain_step(pipe, frame)
    d = differing_blocks(step, plain)
    if d or not torch.equal(step[6], plain[6]):
        raise RuntimeError(f"bench_northstar: the step differs from K1's and K2's plain versions ({d} blocks)")
    out["bench_northstar"] = {"geometry": f"{W8K}x{H8K} UYVY q80 4:2:2 + {FEC}", "launches_per_step": step_l,
                              "equal_plain": True, **{k: v for k, v in ns.items() if k.endswith("_ms")}}
    seconds["bench_northstar"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _, launches["bench_jpeg_dev"] = counted(lambda: bench_jpeg_dev.main([]))
    enc4 = JpegEncoder(*bench_jpeg_dev.SIZE)
    f4 = bench_jpeg_dev.make_frame(*bench_jpeg_dev.SIZE, device=dev)
    d = differing_blocks(enc4.encode_device(f4), enc4.encode_plain(f4))
    if d:
        raise RuntimeError(f"bench_jpeg_dev: {d} blocks differ from the plain version")
    out["bench_jpeg_dev"] = {"ms": bench_jpeg_dev.timeit(enc4.encode_device, f4, 20), "differing_blocks_vs_plain": d}
    seconds["bench_jpeg_dev"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sc, launches["bench_scan_decode"] = counted(lambda: bench_scan_decode.run(W4K, H4K, 80, 8, dev))
    base = sc[1][2]
    for n, (_, _, coeffs) in sc.items():
        if not all(np.array_equal(a, b) for a, b in zip(base, coeffs)):
            raise RuntimeError(f"bench_scan_decode: {n} threads' coefficients differ from 1 thread's")
    if bench_scan_decode.make_stream(W4K, H4K, 80, dev) != bench_scan_decode.make_stream(W4K, H4K, 80, cpu):
        raise RuntimeError("bench_scan_decode: the card's stream differs from the CPU port's")
    out["bench_scan_decode"] = {"threads": {n: {"min_ms": a, "median_ms": b} for n, (a, b, _) in sc.items()},
                                "coefficients_equal_every_thread_count": True, "stream_equal_cpu": True}
    seconds["bench_scan_decode"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    hr = bench_h264_enc_dev.run(W1080, H1080, 26, dev)
    cpu_args = tuple(torch.from_numpy(a) for a in bench_h264_enc_dev.frames(W1080, H1080))
    for stage in STOP_STAGES:
        want = make_device_encode_p(W1080, H1080, 26, 8, wwords=32, _stop_after=stage, device="cpu")(*cpu_args)
        got = hr["stage_outputs"][stage]
        if len(got) != len(want) or not all(g.is_cuda and torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise RuntimeError(f"bench_h264_enc_dev: stage {stage}'s outputs on the card differ from the CPU's")
    out["bench_h264_enc_dev"] = {"geometry": f"{W1080}x{H1080} qp 26 search 8", "p_ms": hr["p"],
                                 "stages_ms": hr["stages"], "intra_ms": hr["intra"], "stages_equal_cpu": True}
    seconds["bench_h264_enc_dev"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    w, h, fps, n = TOOLS_LATENCY
    bench_latency.warm_graphs(w, h, "jpeg", dev)
    port = free_port_pair()
    (lat, shown), launches["bench_latency"] = counted(
        lambda: bench_latency.run_session(w, h, fps, n, "jpeg", FEC, port=port, device=dev))
    if len(lat) != n:
        raise RuntimeError(f"bench_latency: {len(lat)} of {n} frames displayed")
    summary = bench_latency.summarize(w, h, fps, "jpeg", FEC, lat, shown)
    emit(summary)  # the tool's own --json line
    out["bench_latency"] = {**summary, "displayed": len(lat), "frames_sent": n + 60}
    seconds["bench_latency"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rr, launches["bench_receiver"] = counted(
        lambda: bench_receiver.run(W1080, H1080, TOOLS_RECEIVER_FRAMES, dev, port=free_port_pair()))
    if rr["frames"] < 3:
        raise RuntimeError(f"bench_receiver: {rr['frames']} frames shown")
    out["bench_receiver"] = {k: v for k, v in rr.items() if k != "latencies_ms"}
    seconds["bench_receiver"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out.update(tools_captures(dev))
    seconds["captures"] = time.perf_counter() - t0
    out["launches"] = {k: {tool: launches[tool][k] for tool in launches}
                       for k in ("jpeg_encode", "gf2_parity", "jpeg_decode")}
    out["seconds_by_part"] = seconds
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---- phase remaining: the last slice ----

REM_FRAMES = 60  # row (a): 1 s of the 1080p60 session into a windowed display
REM_XLATE_FRAMES = 5  # row (b): uncompressed 1080p frames into the translator
REM_CAMERA_FRAMES = 10  # row (e)


def remaining_windowed(dev):
    """(a) the 1080p60 JPEG q80 + LDGM 256:26:5 session with one seeded data
    packet lost a frame (the peel on the card) into ``-d x11`` against the
    mock X server: every shown window image byte-equal to the CPU port's x11
    rendering of the CPU decode of the file sent under that frame's RTP
    timestamp.  ``-d gl`` is not run: the card's machine has no libEGL.so.1
    (PERF.md, PR 13)."""
    from tests.torch_x11_mock import MockXServer
    from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress
    from ultragrid_tpu_torch.modules.x11_display import X11Display
    from ultragrid_tpu_torch.ops.jpeg import _parse_headers
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rem_")
    files, packets, shown = {}, [], []
    srv = MockXServer(os.path.join(tmp, "X0"), width=W1080, height=H1080)
    cpu_srv = MockXServer(os.path.join(tmp, "X1"), width=W1080, height=H1080)
    try:
        def after(frame, display):
            img = next(iter(srv.windows.values()))
            shown.append((int(round(frame.timestamp * 90000)) & 0xFFFFFFFF, frame.data.is_cuda,
                          int(frame.desc.color_spec), img.tobytes()))

        t0 = time.perf_counter()
        run, _, _ = live_run(dev, LIVE_CAPTURE, "jpeg:80", FEC, REM_FRAMES, loss=LIVE_LOSS,
                             display=f"x11:display={srv.path}", after_shown=after,
                             tap=lambda sender: tap_sent_files(sender, files, packets))
        seconds = time.perf_counter() - t0
        # the CPU port's rendering of each distinct file: the CPU decode to
        # RGB, shown by the port's x11 display on the CPU
        cpu_dec = JpegDecompress(device="cpu")
        cpu_disp = X11Display(f"display={cpu_srv.path}", device="cpu")
        cpu_disp.reconfigure(VideoDesc(W1080, H1080, Codec.RGB, 60.0))
        rendered = {}
        for ts, on_card, codec, img in shown:
            if ts not in files:
                raise RuntimeError(f"remaining (a): a shown frame has no sent file under RTP ts {ts}")
            f = files[ts]
            if f not in rendered:
                hdr = _parse_headers(f)
                jf = VideoFrame(VideoDesc(hdr["w"], hdr["h"], Codec.JPEG, 60.0), [np.frombuffer(f, np.uint8)])
                cpu_disp.put_frame(cpu_dec.decompress(jf, Codec.RGB))
                rendered[f] = next(iter(cpu_srv.windows.values())).tobytes()
            if not on_card or codec != int(Codec.RGB) or img != rendered[f]:
                raise RuntimeError(f"remaining (a): a shown window image is not the CPU port's rendering "
                                   f"(on the card {on_card}, codec {codec})")
        cpu_disp.done()
    finally:
        srv.close()
        cpu_srv.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if len(shown) < REM_FRAMES // 4 or run["launches"]["jpeg_encode"] < 1 or run["launches"]["gf2_parity"] < 1:
        raise RuntimeError(f"remaining (a): {len(shown)} frames shown, {run}")
    keep = ("frames_sent", "frames_displayed", "frames_per_s", "latency_ms_p50", "latency_ms_p95",
            "packets_dropped", "fec_jobs", "fec_jobs_recovered", "launches")
    return {**{k: run[k] for k in keep}, "display": "x11 (mock X server, 1920x1080 PutImage)",
            "frames_checked": len(shown), "distinct_files": len(set(files.values())),
            "equal_to_cpu_rendering": True, "seconds": seconds,
            "gl": "not run: no libEGL.so.1 on the card's machine (PERF.md, PR 13)"}


def remaining_translator(dev):
    """(b) ``hd_rum_translator`` on the card: uncompressed 1080p UYVY in, one
    client with ``-c jpeg`` (K1 on the card) and one raw; the JPEG client's
    files equal the CPU port's ``jpeg`` encode of the frames sent, the raw
    client's frames equal them."""
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture
    from ultragrid_tpu_torch.modules.video_compress import compress_init
    from ultragrid_tpu_torch.net.pbuf import PlayoutBuffer
    from ultragrid_tpu_torch.net.rtp import RtpSession
    from ultragrid_tpu_torch.net.transmit import Tx
    from ultragrid_tpu_torch.net.video_rx import VideoRxState
    from ultragrid_tpu_torch.tools.hd_rum_translator import HdRumTranslator
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame

    ring = initialize_video_capture(LIVE_CAPTURE, device="cpu").frames
    sent = [ring[i % len(ring)] for i in range(REM_XLATE_FRAMES)]
    rx_port, jpeg_port, raw_port = free_port_pair(), free_port_pair(), free_port_pair()
    got = {jpeg_port: {}, raw_port: {}}
    stop = threading.Event()

    def client(port):
        sess = RtpSession(addr=None, rx_port=port, tx_port=0)
        pbuf, state = PlayoutBuffer(), VideoRxState(device="cpu")

        def handle(node):
            frame = state.decode_frame(node)
            if frame is not None:
                data = frame.data.cpu().numpy() if isinstance(frame.data, torch.Tensor) else np.asarray(frame.data)
                got[port][node.ts] = (int(frame.desc.color_spec), data.tobytes())
            return frame is not None

        try:
            while not stop.is_set():
                for pkt in sess.recv_many(timeout=0.001, max_pkts=256):
                    pbuf.insert(pkt)
                now = time.monotonic()
                pbuf.decode(now, handle)
                pbuf.remove_old(now)
        finally:
            sess.close()

    threads = [threading.Thread(target=client, args=(p,), daemon=True) for p in (jpeg_port, raw_port)]
    for t in threads:
        t.start()
    translator = HdRumTranslator(rx_port, [("127.0.0.1", jpeg_port, "jpeg"), ("127.0.0.1", raw_port, "none")],
                                 device=dev)
    tt = threading.Thread(target=translator.run, kwargs={"frame_limit": REM_XLATE_FRAMES, "timeout": 60},
                          daemon=True)
    reset_kernel_counts()
    t0 = time.perf_counter()
    tt.start()
    sender = RtpSession(addr="127.0.0.1", rx_port=0, tx_port=rx_port)
    tx = Tx(mtu=9000, device="cpu")
    # paced as a 5 frames/s source: the Tx spreads a frame's packets over its
    # period, and each end's Python receive loop reads 1080p uncompressed
    # (the raw client's 2,765 packets a frame at MTU 1500) as they come
    desc = VideoDesc(W1080, H1080, Codec.UYVY, 5.0)
    for i, f in enumerate(sent):
        frame = VideoFrame(desc, [f])
        frame.timestamp = i / 5.0
        tx.send_video(sender, frame)
        time.sleep(0.2)
    tt.join(timeout=60)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and min(len(v) for v in got.values()) < REM_XLATE_FRAMES:
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=5)
    sender.close()
    torch.cuda.synchronize()
    launches = kernel_counts()
    seconds = time.perf_counter() - t0
    cpu_jpeg = compress_init("jpeg", device="cpu")
    want_jpeg = {cpu_jpeg.compress(VideoFrame(desc, [f])).data.tobytes() for f in sent}
    want_raw = {f.numpy().tobytes() for f in sent}
    jpegs, raws = list(got[jpeg_port].values()), list(got[raw_port].values())
    if (translator.frames_forwarded < REM_XLATE_FRAMES or len(jpegs) < REM_XLATE_FRAMES
            or len(raws) < REM_XLATE_FRAMES or launches["jpeg_encode"] < REM_XLATE_FRAMES):
        raise RuntimeError(f"remaining (b): forwarded {translator.frames_forwarded}, jpeg client {len(jpegs)}, "
                           f"raw client {len(raws)}, launches {launches}")
    if any(c != int(Codec.JPEG) or d not in want_jpeg for c, d in jpegs):
        raise RuntimeError("remaining (b): a JPEG client file is not the CPU port's encode of a sent frame")
    if any(c != int(Codec.UYVY) or d not in want_raw for c, d in raws):
        raise RuntimeError("remaining (b): a raw client frame is not a sent frame")
    return {"frames_sent": REM_XLATE_FRAMES, "frames_forwarded": translator.frames_forwarded,
            "jpeg_client_files": len(jpegs), "raw_client_frames": len(raws), "jpeg_equal_to_cpu_encode": True,
            "raw_equal_to_input": True, "launches": launches, "seconds": seconds}


def remaining_convert(dev):
    """(c) ``tools/convert.py`` on the card (its default) and on the CPU: 4K
    UYVY -> RGB and v210 -> UYVY, the output files byte-equal."""
    from ultragrid_tpu_torch.tools import convert
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize

    tmp = tempfile.mkdtemp(prefix="chip_smoke_convert_")
    out = {}
    try:
        for a, b in (("UYVY", "RGB"), ("v210", "UYVY")):
            src = os.path.join(tmp, f"in.{a}")
            np.random.default_rng(31).integers(0, 256, (H4K, vc_get_linesize(W4K, Codec[a])),
                                               dtype=np.uint8).tofile(src)
            t0 = time.perf_counter()
            rc_card = convert.main([f"{W4K}x{H4K}", a, src, b, src + ".card"])
            card_s = time.perf_counter() - t0
            rc_cpu = convert.main([f"{W4K}x{H4K}", a, src, b, src + ".cpu", "--device", "cpu"])
            with open(src + ".card", "rb") as f1, open(src + ".cpu", "rb") as f2:
                card, cpu = f1.read(), f2.read()
            if rc_card or rc_cpu or card != cpu or len(card) != vc_get_linesize(W4K, Codec[b]) * H4K:
                raise RuntimeError(f"remaining (c): convert {a} -> {b}: rc {rc_card}/{rc_cpu}, "
                                   f"{len(card)} / {len(cpu)} bytes, equal {card == cpu}")
            out[f"{a}->{b}"] = {"bytes": len(card), "byte_equal_to_cpu": True, "card_command_s": card_s}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def remaining_lavc(dev):
    """(d) where libavcodec is present: ``-c libavcodec:codec=H.264`` 1080p
    to a receiver with ``--param h264-decoder=lavc`` (frames on the card,
    equal to the CPU port's decode), ``-x mpegts`` (30 frames), ``-A opus``
    through the session, ``bench_h264_decode`` at its default size.  Where
    its headers are absent: one line that says so."""
    from ultragrid_tpu_torch.modules.lavc import LavcDecompress, lavc_available

    if not lavc_available():
        return {"libavcodec": "absent: cc finds no libavcodec/avcodec.h on this machine; row (d) not run"}
    from ultragrid_tpu_torch.pipeline.mpegts import MpegTsReceiver, MpegTsSender
    from ultragrid_tpu_torch.tools import bench_h264_decode
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame
    from ultragrid_tpu_torch.utils import params

    out = {"libavcodec": "present"}
    files, packets, shown = {}, [], []

    def on_shown(frame):
        shown.append((int(round(frame.timestamp * 90000)) & 0xFFFFFFFF, frame.data.is_cuda, frame.data.cpu()))

    params.set_commandline_param("h264-decoder", "lavc")
    run, _, _ = live_run(dev, LIVE_CAPTURE, "libavcodec:codec=H.264", "none", 60, on_shown=on_shown,
                         tap=lambda sender: tap_sent_files(sender, files, packets))
    cpu_dec = LavcDecompress(device="cpu")
    cpu = {}
    for ts in sorted(files):
        f = cpu_dec.decompress(VideoFrame(VideoDesc(W1080, H1080, Codec.H264, 60.0),
                                          [np.frombuffer(files[ts], np.uint8)]), Codec.UYVY)
        if f is not None:
            cpu[ts] = f.data
    if not shown or any(not c or ts not in cpu or not torch.equal(d, cpu[ts]) for ts, c, d in shown):
        raise RuntimeError(f"remaining (d): lavc H.264 session, {len(shown)} shown, not the CPU port's decode")
    out["h264_lavc_session"] = {k: run[k] for k in ("frames_sent", "frames_displayed", "frames_per_s")}
    port = free_port_pair()
    recv = MpegTsReceiver("dummy", port=port, frame_limit=30, timeout=5.0, device=dev)
    rt = threading.Thread(target=recv.run, daemon=True)
    rt.start()
    time.sleep(0.3)
    MpegTsSender(LIVE_CAPTURE, "127.0.0.1", port, frame_limit=30, device=dev).run()
    rt.join(timeout=60)
    if recv.frames_displayed < 1:
        raise RuntimeError("remaining (d): mpegts showed no frame")
    out["mpegts"] = {"frames_sent": 30, "frames_displayed": recv.frames_displayed}
    audio, _, _ = live_run(dev, LIVE_CAPTURE, "jpeg:80", FEC, 30, audio_capture="testcard",
                           sender_kw={"audio_codec": "Opus"})
    if audio["audio"]["frames_played"] < 1:
        raise RuntimeError(f"remaining (d): -A Opus played no audio frame: {audio['audio']}")
    out["opus_session"] = {"frames_sent": audio["frames_sent"], "frames_displayed": audio["frames_displayed"],
                           "audio_frames_sent": audio["audio"]["frames_sent"],
                           "audio_frames_played": audio["audio"]["frames_played"]}
    out["bench_h264_decode_rc"] = bench_h264_decode.main(["--device", str(dev)])
    return out


def remaining_camera_alias(dev):
    """(e) ``-t camera`` through ``cli.main`` with ``HOME`` at a temporary
    ``.ug.rc`` that aliases ``camera`` to the 1080p testcard: the frames
    shown are on the card and equal to the testcard's."""
    from ultragrid_tpu_torch import cli
    from ultragrid_tpu_torch.modules import extra_displays
    from ultragrid_tpu_torch.modules.video_capture import initialize_video_capture

    home = tempfile.mkdtemp(prefix="chip_smoke_home_")
    with open(os.path.join(home, ".ug.rc"), "w") as fh:
        fh.write("alias capture camera testcard:s=1920x1080\n")
    got = []
    extra_displays.register_pipe_delegate("chip_smoke_ugrc", got.append)
    saved = os.environ.get("HOME")
    os.environ["HOME"] = home
    try:
        t0 = time.perf_counter()
        rc = cli.main(["-t", "camera", "-d", "pipe:chip_smoke_ugrc", "--frames", str(REM_CAMERA_FRAMES)])
        seconds = time.perf_counter() - t0
    finally:
        os.environ["HOME"] = saved if saved is not None else home
        if saved is None:
            del os.environ["HOME"]
        shutil.rmtree(home, ignore_errors=True)
    frames = [f for f in got if f is not None]
    ring = [f.cpu() for f in initialize_video_capture("testcard:s=1920x1080", device=dev).frames]
    if rc != 0 or len(frames) != REM_CAMERA_FRAMES or not all(f.data.is_cuda for f in frames):
        raise RuntimeError(f"remaining (e): rc {rc}, {len(frames)} frames, on the card "
                           f"{[f.data.is_cuda for f in frames]}")
    if not all(any(torch.equal(f.data.cpu(), r) for r in ring) for f in frames):
        raise RuntimeError("remaining (e): a frame is not the 1920x1080 testcard's")
    return {"frames": len(frames), "on_card": True, "equal_to_testcard": True,
            "geometry": f"{frames[0].desc.width}x{frames[0].desc.height}", "seconds": seconds}


def phase_remaining(dev):
    """The last slice's card path: (a) the 1080p60 JPEG + LDGM session with
    loss into ``-d x11``, (b) ``hd_rum_translator`` with a ``-c jpeg`` and a
    raw client, (c) ``tools/convert.py`` at 4K, (d) the libavcodec rows where
    libavcodec is present, (e) ``-t camera`` through a ``.ug.rc`` alias.
    K1 and K2 counted in (a) and (b)."""
    t_phase = time.perf_counter()
    out = {"phase": "remaining", "card": nvidia_smi_line()}
    out["windowed_x11"] = remaining_windowed(dev)
    out["translator"] = remaining_translator(dev)
    out["convert_4k"] = remaining_convert(dev)
    out["lavc"] = remaining_lavc(dev)
    out["camera_alias"] = remaining_camera_alias(dev)
    out["launches"] = {k: out["windowed_x11"]["launches"][k] + out["translator"]["launches"][k]
                       for k in ("jpeg_encode", "gf2_parity", "jpeg_decode")}
    out["seconds"] = time.perf_counter() - t_phase
    return out


def plane_work(enc):
    """(bytes, FLOP) that one call of K1's per-plane entry over enc's frame
    needs: each frame byte of the MCUs, W, const and the Huffman tables read
    once, the slots and bit counts written once; two FLOP per multiply-add
    of the dense front end (64 x 64 per 8x8 block)."""
    tables = 4 * (64 * 128 + 128 + 544)
    nbytes = enc.height * enc.nmcux * enc.bpr + tables + enc.nblocks * (enc.wwords + 1) * 4 + 1
    return nbytes, 2 * enc.nblocks * 64 * 64


def plane_entry_timing(dev):
    """K1's per-plane entry in PLANE_CASES: the whole per-plane path, frame
    bytes in -> slots out (``JpegEncoder._encode``), by CUDA events, its
    launches and device time per frame and the kernel's device time by the
    profiler, its plain version (the PyTorch front end, then symbols and
    pack, on the card), and its bound (FP32 FMAs)."""
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize

    rows = []
    for w, h, cname, sub, q in PLANE_CASES:
        enc = JpegEncoder(w, h, in_codec=Codec[cname], quality=q, subsampling=sub)
        src = torch.as_tensor(content(h, vc_get_linesize(w, enc.in_codec), 8)).to(dev)

        def run(enc=enc, src=src):
            return enc._encode(src)

        nbytes, flop = plane_work(enc)
        bms, by = bound_ms(nbytes, flop)
        ks = device_kernels(run, expect="jpeg_plane_encode_kernel")
        launches, path_dms = per_step(ks, "jpeg_plane_encode_kernel")
        count, kms = next(v for n, v in ks.items() if "jpeg_plane_encode_kernel" in n)
        dms = kms / count
        rows.append({"what": f"K1 per-plane entry (jpeg_plane_encode) {w}x{h} {cname} q{q} {sub}",
                     "ms": cuda_ms(run), "device_ms": dms, "path_device_ms": path_dms, "launches_per_frame": launches,
                     "kernels": {n[:60]: list(v) for n, v in ks.items()},
                     "plain_ms": cuda_ms(lambda: enc.encode_plain(src), runs=PLAIN_RUNS, warmup=1),
                     "bound_ms": bms, "bound_by": by, "share_of_bound": bms / dms,
                     "mbytes": nbytes / 1e6, "gflop": flop / 1e9})
    return rows


# ---- phase api: the public names that close the port, on the card ----

# the slot width the q95 encoders of row (a) start from: no 8-bit block at
# q95 needs 32 words (the row reads the widest block at 32), so a noise frame
# escalates only from a narrower start, here 16 words to 32
API_START_WWORDS = 16


def jpeg_file(enc, parts) -> np.ndarray:
    """enc's JPEG file of the seven parts of a device half: its header, the
    C assembly of the slots, EOI."""
    return np.concatenate([np.frombuffer(enc._header, np.uint8), enc.assemble(*parts[:6]),
                           np.frombuffer(b"\xff\xd9", np.uint8)])


def c_path_file(enc, frame) -> np.ndarray:
    """enc's file of ``frame`` as the host C assembly makes it: the device
    half on the frame's device (K1 on the card), widened on overflow, then
    :func:`jpeg_file`.  The independent check of ``JpegEncoder.encode``,
    whose body the assembly kernel makes on the card."""
    out = enc._encode(frame)
    while bool(out[-1]) and enc.wwords < 64:
        out = enc.escalate_and_retry(frame)
    return jpeg_file(enc, out)


def plain_file(enc, frame) -> np.ndarray:
    """enc's file of ``frame`` through the plain version on the frame's
    device, the slots widened on overflow as ``JpegEncoder.encode`` does."""
    out = enc.encode_plain(frame)
    while bool(out[-1]) and enc.wwords < 64:
        enc.wwords *= 2
        out = enc.encode_plain(frame)
    return jpeg_file(enc, out)


def api_warm_row(dev, subsampling):
    """(a) ``JpegEncoder.warm`` at 1080p UYVY q95 (K1, or with 4:4:4 its
    per-plane entry): warm() at the start width and its escalation, then a
    seeded noise frame that overflows the start width and escalates.  The
    file must equal the plain version's on the card and the CPU's; warm()'s
    seconds and the escalated encode's ms beside a cold encoder's are
    recorded, not gated."""
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize

    def q95():
        enc = JpegEncoder(W1080, H1080, in_codec=Codec.UYVY, quality=95, subsampling=subsampling)
        enc.wwords = API_START_WWORDS
        return enc

    noise = torch.as_tensor(np.random.default_rng(31).integers(
        0, 256, (H1080, vc_get_linesize(W1080, Codec.UYVY)), dtype=np.uint8)).to(dev)
    start = JpegEncoder(W1080, H1080, in_codec=Codec.UYVY, quality=95, subsampling=subsampling)
    widest = max(int(b.max()) for b in start._encode(noise)[1:6:2])
    warm = q95()
    t0 = time.perf_counter()
    warm.warm()
    warm_s = time.perf_counter() - t0
    if warm.wwords != API_START_WWORDS:
        raise RuntimeError(f"api (a) {subsampling}: warm() changed the slot width to {warm.wwords}")
    t0 = time.perf_counter()
    got = warm.encode(noise)
    warm_ms = (time.perf_counter() - t0) * 1e3
    if warm.wwords != 2 * API_START_WWORDS:
        raise RuntimeError(f"api (a) {subsampling}: the noise frame escalated to {warm.wwords} words, "
                           f"not {2 * API_START_WWORDS}")
    cold = q95()
    t0 = time.perf_counter()
    got_cold = cold.encode(noise)
    cold_ms = (time.perf_counter() - t0) * 1e3
    if not (np.array_equal(got, plain_file(q95(), noise)) and np.array_equal(got, q95().encode(noise.cpu()))
            and np.array_equal(got, got_cold) and np.array_equal(got, c_path_file(q95(), noise))):
        raise RuntimeError(f"api (a) {subsampling}: the escalated file differs from the plain version's "
                           "on the card, the CPU's or the C assembly's")
    return {"geometry": f"{W1080}x{H1080} UYVY q95 {warm.subsampling}, seeded noise",
            "start_wwords": start.wwords, "widest_block_bits_at_start": widest,
            "forced_start_wwords": API_START_WWORDS, "escalated_to_wwords": warm.wwords,
            "file_equal_plain_card_cpu_and_c_assembly": True, "warm_s": warm_s, "escalated_encode_ms_after_warm": warm_ms,
            "escalated_encode_ms_cold": cold_ms, "file_bytes": int(got.size)}


def phase_api(dev):
    """The names that close the port's public API, on the card at 1080p:
    (a) ``JpegEncoder.warm`` and a forced escalation (K1, and its per-plane
    entry); (b) ``jpeg_encode_core`` on a 1080p UYVY q80 frame, its parts
    assembling to the CPU's file, one K1 launch a call by the profiler, and
    ``JpegEncoder.encode`` of the frame on the card (one K1 launch and one
    assembly) byte-equal to the C assembly of those parts; (c)
    ``lavc_encoders()`` and the registered audio codecs on this machine,
    both empty of libavcodec where its headers are absent, as the
    reference's are.  K1's launches in the phase are read around it."""
    from ultragrid_tpu_torch.audio import codecs as audio_codecs
    from ultragrid_tpu_torch.audio.lavc_codecs import LAVC_CODECS
    from ultragrid_tpu_torch.modules.lavc import lavc_available, lavc_encoders
    from ultragrid_tpu_torch.ops import jpeg_cuda
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder, jpeg_encode_core
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize

    t_phase = time.perf_counter()
    out = {"phase": "api", "card": nvidia_smi_line()}
    reset_kernel_counts()
    out["warm"] = api_warm_row(dev, None)
    out["warm_per_plane"] = api_warm_row(dev, "444")

    frame = torch.as_tensor(content(H1080, vc_get_linesize(W1080, Codec.UYVY), 32)).to(dev)
    before = jpeg_cuda.LAUNCHES.count
    parts = jpeg_encode_core(frame, W1080, Codec.UYVY, 80)
    if jpeg_cuda.LAUNCHES.count != before + 1 or bool(parts[-1]) or not all(p.is_cuda for p in parts):
        raise RuntimeError("api (b): jpeg_encode_core is not one K1 launch on the card without overflow")
    enc = JpegEncoder(W1080, H1080, in_codec=Codec.UYVY, quality=80)
    got, want = jpeg_file(enc, parts), enc.encode(frame.cpu())
    if not np.array_equal(got, want):
        raise RuntimeError(f"api (b): jpeg_encode_core's file ({got.size} bytes) is not the CPU's ({want.size})")
    before = kernel_counts()
    on_card = enc.encode(frame)
    after = kernel_counts()
    if not np.array_equal(on_card, got):
        raise RuntimeError(f"api (b): JpegEncoder.encode on the card ({on_card.size} bytes) is not the C "
                           f"assembly's file ({got.size})")
    if (after["jpeg_encode"] - before["jpeg_encode"], after["jpeg_assemble"] - before["jpeg_assemble"]) != (1, 1):
        raise RuntimeError(f"api (b): JpegEncoder.encode launched {before} -> {after}, want one K1 and one "
                           "assembly")
    # single-call profiles (the profiler never adds a launch, and may drop one)
    prof = complete_profiles(lambda: jpeg_encode_core(frame, W1080, Codec.UYVY, 80), {"jpeg_encode_kernel": 1})
    out["encode_core"] = {
        "geometry": f"{W1080}x{H1080} UYVY q80", "file_bytes": int(got.size), "file_equal_cpu": True,
        "encode_on_card_equal_c_assembly": True,
        "k1_launches_a_call": 1, "profile_a_call": prof,
        "host_ms_a_call": host_ms(lambda: [p.cpu() for p in jpeg_encode_core(frame, W1080, Codec.UYVY, 80)],
                                  runs=5)}

    encoders, registered = lavc_encoders(), sorted(audio_codecs._CODECS)
    lavc_names = [cls.NAME for cls in LAVC_CODECS]
    lavc_registered = [n for n in lavc_names if n in registered]
    present = lavc_available()
    if bool(encoders) != present or lavc_registered != (lavc_names if present else []):
        raise RuntimeError(f"api (c): libavcodec {'present' if present else 'absent'}, but encoders "
                           f"{encoders[:5]} and lavc audio codecs {lavc_registered}")
    out["lavc"] = {"libavcodec": "present" if present else "absent", "lavc_encoders": encoders,
                   "audio_codecs_registered": registered}
    out["launches"] = kernel_counts()
    if min(out["launches"][k] for k in ("jpeg_encode", "jpeg_plane_encode", "jpeg_assemble")) < 1:
        raise RuntimeError(f"api: a kernel of the phase was not launched: {out['launches']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "ultragrid_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(ultragrid_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1

    from ultragrid_tpu_torch import _build, get_device, native
    from ultragrid_tpu_torch.models.encode import EncodeConfig, EncodePipeline
    from ultragrid_tpu_torch.ops import fec as fec_ops
    from ultragrid_tpu_torch.ops import jpeg_cuda
    from ultragrid_tpu_torch.modules.video_decompress import JpegDecompress
    from ultragrid_tpu_torch.ops.fec import _LDGM_SUGGESTED, LdgmSession, symbol_words
    from ultragrid_tpu_torch.ops.jpeg import (JpegDecoder, JpegEncoder, entropy_decode_422_packed,
                                              packed_coefficients)
    from ultragrid_tpu_torch.types import Codec, VideoDesc, VideoFrame, vc_get_linesize

    # ---- device ----
    dev = get_device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- build: one nvcc per source, in parallel ----
    t0 = time.time()
    _build.kernels_lib()
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    emit({"phase": "build", "seconds": round(time.time() - t0, 3), "ptxas": ptxas})

    # ---- host C stages shared with the reference (raise if they do not build) ----
    native.jpeg_assemble_lib()
    native.ldgm_xor_lib()
    native.jpeg_scan_decode_lib()
    emit({"phase": "host", "jpeg_assemble": True, "ldgm_xor": True, "jpeg_scan_decode": True})
    if sys.argv[1:] == ["--only", "standards"]:
        # a quicker reading of this slice's phase alone; prints no result line
        emit(phase_standards(dev))
        return 0
    if sys.argv[1:] == ["--only", "parallel"]:
        emit(phase_parallel(dev))
        return 0
    if sys.argv[1:] == ["--only", "banded_session"]:
        emit({"phase": "banded_session", **banded_session(dev)})
        return 0
    if sys.argv[1:] == ["--only", "assemble"]:
        emit(phase_assemble(dev))
        return 0
    if sys.argv[1:] == ["--only", "tools"]:
        emit(phase_tools(dev))
        return 0
    if sys.argv[1:] == ["--only", "remaining"]:
        emit(phase_remaining(dev))
        return 0
    if sys.argv[1:] == ["--only", "api"]:
        emit(phase_api(dev))
        return 0
    if sys.argv[1:] == ["--only", "card_decode"]:
        emit({"phase": "card_decode", "rows": card_decode_rows(dev)})
        return 0

    def frame_for(enc, seed, noise=False):
        ls = vc_get_linesize(enc.width, enc.in_codec)
        if noise:
            f = np.random.default_rng(seed).integers(0, 256, (enc.height, ls), dtype=np.uint8)
        else:
            f = content(enc.height, ls, seed)
        return torch.as_tensor(f).to(dev)

    def dyadic(enc):
        st = dict(enc.state)
        st["W"] = np.round(st["W"] * 64) / 64
        st["const"] = np.round(st["const"] * 64) / 64
        return JpegEncoder(enc.width, enc.height, in_codec=enc.in_codec, quality=enc.quality,
                           restart_interval=enc.restart_interval, subsampling=enc.subsampling, state=st)

    # ---- k1: kernel vs plain version on the card ----
    # dyadic W: every f32 product and partial sum is exact, so any summation
    # order gives the same coefficients and kernel and plain version must be
    # bit-equal; real W: the differing blocks are counted (0 expected: both
    # run one fmaf chain over S_g in ascending k)
    cases = []
    k1_err = 0
    geoms = [(W1080, H1080, Codec.UYVY, 80, None, None), (W4K, H4K, Codec.UYVY, 80, None, None),
             (*SMALL, Codec.UYVY, 80, None, "420"), (*SMALL, Codec.YUYV, 95, None, None),
             (*SMALL, Codec.RGB, 80, None, None), (*SMALL, Codec.RGBA, 90, None, None)]
    nmcu1080 = (W1080 // 16) * (H1080 // 8)
    # restart intervals at 1080p: every MCU, a non-divisor of the MCU row,
    # (the default is the first case), and one segment for the whole frame
    geoms += [(W1080, H1080, Codec.UYVY, 80, ri, None) for ri in (1, 7, nmcu1080)]
    for (w, h, codec, q, ri, sub) in geoms:
        enc = JpegEncoder(w, h, in_codec=codec, quality=q, restart_interval=ri, subsampling=sub)
        label = f"{w}x{h} {codec.name} q{q} {enc.subsampling} ri{enc.restart_interval}"
        fr = frame_for(enc, 1)
        enc_d = dyadic(enc)
        got, want = enc_d._encode(fr), enc_d.encode_plain(fr)
        err_d, nd_d = max_abs_err(got, want), differing_blocks(got, want)
        if err_d or nd_d:
            raise RuntimeError(f"K1 {label}: differs from the plain path under dyadic W "
                               f"({nd_d} blocks, max abs err {err_d})")
        got, want = enc._encode(fr), enc.encode_plain(fr)
        nd = differing_blocks(got, want)
        k1_err = max(k1_err, max_abs_err(got, want))
        if nd > MAX_DIFF_BLOCK_SHARE * enc.nblocks:
            raise RuntimeError(f"K1 {label}: {nd} of {enc.nblocks} blocks differ under the real W")
        cases.append({"geometry": label, "dyadic_w_bit_equal": True,
                      "differing_blocks": nd, "blocks": enc.nblocks})
    # overflow: slots of 2 words cannot hold noise at q95; encode() escalates
    enc_o = dyadic(JpegEncoder(256, 64, quality=95))
    enc_o.wwords = 2
    fr = frame_for(enc_o, 2, noise=True)
    ovf = enc_o._encode(fr)[-1]
    if not bool(ovf) or not bool(enc_o.encode_plain(fr)[-1]):
        raise RuntimeError("K1 overflow case did not flag overflow")
    file_k = enc_o.encode(fr)
    enc_p = dyadic(JpegEncoder(256, 64, quality=95))
    enc_p.wwords = 2
    file_p = enc_p.encode(fr.cpu())
    if enc_o.wwords != enc_p.wwords or not np.array_equal(file_k, file_p):
        raise RuntimeError("K1 escalation: file differs from the CPU plain path")
    # the per-plane geometries: one launch of K1's per-plane entry (frame
    # bytes in, slots out) equals its plain version on the card (the PyTorch
    # front end, then symbols and pack) bit for bit, and the file equals the
    # CPU's, at restart intervals 1, 7 and the default; the plain front end
    # on the card equals the CPU's
    p2_cases = []
    plane_err = 0
    for w, h, cname, sub, q in PLANE_CASES:
        for ri in (None, 1, 7):
            enc = JpegEncoder(w, h, in_codec=Codec[cname], quality=q, restart_interval=ri, subsampling=sub)
            label = f"{w}x{h} {cname} q{q} {sub} ri{enc.restart_interval}"
            fr = frame_for(enc, 21)
            if ri is None and not torch.equal(enc.plane_coefficients(fr).cpu(), enc.plane_coefficients(fr.cpu())):
                raise RuntimeError(f"per-plane front end {label}: the card differs from the CPU")
            before = jpeg_cuda.PLANE_LAUNCHES.count
            got = enc._encode(fr)
            if jpeg_cuda.PLANE_LAUNCHES.count != before + 1:
                raise RuntimeError(f"K1 per-plane entry {label}: not one launch")
            want = enc.encode_plain(fr)
            err, nd = max_abs_err(got, want), differing_blocks(got, want)
            plane_err = max(plane_err, err)
            if err or nd:
                raise RuntimeError(f"K1 per-plane entry {label}: {nd} blocks differ from its plain version")
            if not np.array_equal(enc.encode(fr), enc.encode(fr.cpu())):
                raise RuntimeError(f"per-plane {label}: the file differs from the CPU plain path")
            p2_cases.append({"geometry": label, "bit_equal_to_plain": True, "differing_blocks": nd,
                             "file_equal_to_cpu": True})
    # overflow: 2-word slots cannot hold noise at q95; encode() escalates
    enc_po = JpegEncoder(256, 64, in_codec=Codec.UYVY, quality=95, subsampling="444")
    enc_po.wwords = 2
    fr = frame_for(enc_po, 2, noise=True)
    got, want = enc_po._encode(fr), enc_po.encode_plain(fr)
    if not bool(got[-1]) or max_abs_err(got, want) or differing_blocks(got, want):
        raise RuntimeError("K1 per-plane entry overflow case: not flagged, or differs from its plain version")
    enc_pc = JpegEncoder(256, 64, in_codec=Codec.UYVY, quality=95, subsampling="444")
    enc_pc.wwords = 2
    if not np.array_equal(enc_po.encode(fr), enc_pc.encode(fr.cpu())) or enc_po.wwords != enc_pc.wwords:
        raise RuntimeError("K1 per-plane entry escalation: file differs from the CPU plain path")
    emit({"phase": "k1", "max_abs_err": k1_err, "cases": cases, "plane_entry_max_abs_err": plane_err,
          "plane_entry_cases": p2_cases, "overflow_escalated_to_wwords": enc_o.wwords,
          "plane_entry_overflow_escalated_to_wwords": enc_po.wwords})

    # ---- k2: parts -> parity -> staircase vs its plain version ----
    desc1080 = VideoDesc(W1080, H1080, Codec.UYVY, 60.0)
    desc8k = VideoDesc(W8K, H8K, Codec.UYVY, 60.0)
    cfg = EncodeConfig(in_codec=Codec.UYVY, compress="jpeg", fec=FEC)
    pipe = EncodePipeline(desc1080, cfg, device=dev)
    pipe8 = EncodePipeline(desc8k, cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    k2_err = 0
    k2_cases = []
    k2_parts = {}
    for label, p in (("1080p", pipe), ("8K", pipe8)):
        rnd = [torch.randint(-2**31, 2**31 - 1, (w,), dtype=torch.int32, device=dev, generator=gen)
               for w in p.part_words]
        real = list(p.jpeg_encoder._encode(frame_for(p.jpeg_encoder, 7))[:6])
        k2_parts[label] = real
        for kind, parts in (("random", rnd), ("real", real)):
            got, want = p.parity(*parts), p.parity.plain(*parts)
            k2_err = max(k2_err, max_abs_err([got], [want]))
            if not torch.equal(got, want):
                raise RuntimeError(f"K2 {label} {kind}: differs from its plain version")
            k2_cases.append({"geometry": label, "parts": kind, "psw": p.psw,
                             "container_rows": p.parity.rows, "m": p.m, "bit_equal": True})
    emit({"phase": "k2", "max_abs_err": k2_err, "cases": k2_cases})

    # ---- main path: the sender step at the entry geometry ----
    frame_np = content(H1080, vc_get_linesize(W1080, Codec.UYVY), 3)
    frame = torch.as_tensor(frame_np).to(dev)
    torch.cuda.synchronize()
    jpeg_cuda.LAUNCHES.reset()
    fec_ops.LAUNCHES.reset()
    outs = pipe(frame)
    torch.cuda.synchronize()
    launches = {"jpeg_encode": jpeg_cuda.LAUNCHES.count, "gf2_parity": fec_ops.LAUNCHES.count}
    if min(launches.values()) < 1:
        raise RuntimeError(f"main path skipped a kernel: {launches}")
    ys, ybits, us, ubits, vs, vbits, par, ovf = outs
    enc = pipe.jpeg_encoder
    if tuple(ys.shape) != (enc.nmcu * 2, enc.wwords) or tuple(par.shape) != (pipe.m, pipe.ps):
        raise RuntimeError(f"main path shapes {tuple(ys.shape)} {tuple(par.shape)}")
    if bool(ovf) or int(ybits.min()) <= 0:
        raise RuntimeError("main path: overflow or empty blocks")
    # parity against the shared C LDGM encoder over the same container bytes
    k = pipe.fec_desc[1]
    cont = np.zeros((k, pipe.ps), np.uint8)
    rows = sum(pipe.row_counts)
    cont[:rows] = pipe.container([ys, ybits, us, ubits, vs, vbits]).cpu().numpy().view(np.uint8)
    mask = pipe.state["ldgm_mask"]
    row_len = int(mask.sum(axis=1).max())
    idx = np.full((pipe.m, row_len), -1, np.int32)
    for r in range(pipe.m):
        nz = np.nonzero(mask[r])[0]
        idx[r, : nz.size] = nz
    par_c = np.zeros((pipe.m, pipe.ps), np.uint8)
    native.ldgm_xor_lib().ldgm_encode_xor(cont.ctypes.data, k, pipe.ps, idx.ctypes.data,
                                          pipe.m, row_len, par_c.ctypes.data)
    if not np.array_equal(par.cpu().numpy(), par_c):
        raise RuntimeError("main path parity differs from the C ldgm_xor recomputation")
    # the JPEG file through the shared C assembler, against the CPU plain path
    hdr = np.frombuffer(enc._header, np.uint8)
    eoi = np.frombuffer(b"\xff\xd9", np.uint8)
    file_gpu = np.concatenate([hdr, enc.assemble(ys, ybits, us, ubits, vs, vbits), eoi])
    pipe_cpu = EncodePipeline(desc1080, cfg, device="cpu")
    outs_cpu = pipe_cpu(torch.as_tensor(frame_np))
    file_cpu = np.concatenate([hdr, pipe_cpu.jpeg_encoder.assemble(*outs_cpu[:6]), eoi])
    if bytes(file_gpu[:2]) != b"\xff\xd8" or bytes(file_gpu[-2:]) != b"\xff\xd9":
        raise RuntimeError("main path JPEG lacks SOI/EOI")
    nd_main = differing_blocks([o.cpu() for o in outs[:6]], outs_cpu[:6])
    if nd_main or not np.array_equal(file_gpu, file_cpu):
        raise RuntimeError(f"main path vs CPU plain: {nd_main} blocks differ")
    if not torch.equal(par.cpu(), outs_cpu[6]):
        raise RuntimeError("main path parity differs from the CPU plain path")
    # every device launch of one step, from the profiler
    step_kernels = device_kernels(lambda: pipe(frame), runs=10, expect="jpeg_encode_kernel")
    step_launches = per_step(step_kernels, "jpeg_encode_kernel")[0]
    strays = [n for n in step_kernels
              if not any(s in n.lower() for s in ("jpeg_encode_kernel", "gf2_parity_kernel", "fill", "memset"))]
    if step_launches > 4 or strays:
        raise RuntimeError(f"main path launches {step_launches} per step, others than K1, K2 "
                           f"and the flag fill: {strays}")
    emit({"phase": "main_path", "geometry": "1920x1080 UYVY jpeg q80 " + FEC, "launches": launches,
          "device_launches_per_step": step_launches,
          "device_kernels_per_step": {n[:60]: c for n, (c, _) in step_kernels.items()},
          "jpeg_bytes": int(file_gpu.size), "same_file_as_cpu_plain": True,
          "differing_blocks_vs_cpu_plain": nd_main, "parity_equals_c_ldgm_xor": True})

    # ---- k2_peel: K2 without the staircase (the peel's row XORs over the
    # full check matrix) and with it (LdgmSession.encode_device) against
    # its plain version, bit for bit ----
    files = {}
    for label, (w, h) in (("1080p", (W1080, H1080)), ("8K", (W8K, H8K))):
        e = JpegEncoder(w, h)
        src = frame_for(e, 11)
        files[label] = (src, e.encode(src))
    peel_cases = []
    k2_peel_err = 0

    def check_k2(sess, block, what):
        nonlocal k2_peel_err
        err, case = k2_peel_case(sess, block, what)
        k2_peel_err = max(k2_peel_err, err)
        peel_cases.append(case)

    sess256 = LdgmSession(256, 26, 5)
    for label in ("1080p", "8K"):
        buf, desc = sess256.encode(files[label][1])
        ps = desc.symbol_size
        real, _ = lose(buf, ps, LOSS_RECOVERED, LOSS_RECOVERED)
        rnd = torch.randint(0, 256, real.shape, dtype=torch.uint8, device=dev, generator=gen)
        check_k2(sess256, rnd, f"{label} 256:26:5 random ps={ps}")
        check_k2(sess256, torch.as_tensor(real).to(dev), f"{label} 256:26:5 real ps={ps}")
    # the default spec, every suggested configuration at its frame size,
    # and a user configuration past the default layout (the TALL variant)
    configs = [(512, 384, 5, files["1080p"][1].size)]
    configs += sorted({(k, m, c, fs) for _, fs, _, k, m, c in _LDGM_SUGGESTED})
    configs += [(6000, 3000, 8, 4147200)]
    for k, m, c, fs in configs:
        sess = LdgmSession(k, m, c)
        ps, _ = sess.encode_params(fs)
        block = torch.randint(0, 256, (k + m, ps), dtype=torch.uint8, device=dev, generator=gen)
        check_k2(sess, block, f"{k}:{m}:{c} random ps={ps}")
    emit({"phase": "k2_peel", "max_abs_err": k2_peel_err, "cases": peel_cases})

    # ---- receive path at the entry geometry: JpegEncoder.encode on the
    # card -> LdgmSession.encode (host C) -> seeded loss -> decode_device on
    # the card -> JpegDecompress on the card, against the CPU plain path ----
    src, _ = files["1080p"]
    enc_r = JpegEncoder(W1080, H1080)
    dec_r = JpegDecompress(device=dev)
    dec_cpu = JpegDecompress(device="cpu")
    desc_j = VideoDesc(W1080, H1080, Codec.JPEG, 60.0)
    reset_kernel_counts()
    file_r = enc_r.encode(src)
    buf, desc = sess256.encode(file_r)
    sym_ok, present_ok = lose(buf, desc.symbol_size, LOSS_RECOVERED, LOSS_RECOVERED)
    rec = sess256.decode_device(torch.as_tensor(sym_ok).to(dev), present_ok)
    rounds_ok = sess256.rounds
    sym_bad, present_bad = lose(buf, desc.symbol_size, LOSS_UNRECOVERABLE, LOSS_UNRECOVERABLE)
    rec_bad = sess256.decode_device(torch.as_tensor(sym_bad).to(dev), present_bad)
    rounds_bad = sess256.rounds
    out = dec_r.decompress(VideoFrame(desc_j, [rec]), Codec.UYVY)
    torch.cuda.synchronize()
    rx_launches = {k: v for k, v in kernel_counts().items() if k not in ("jpeg_plane_encode", "jpeg_decode_refused", "jpeg_assemble")}
    if min(rx_launches.values()) < 1:  # one frame decoded: one jpeg_decode launch
        raise RuntimeError(f"receive path skipped a kernel: {rx_launches}")
    check_card_decode("receive path", kernel_counts(), 1)
    if rec is None or not np.array_equal(rec, file_r):
        raise RuntimeError("receive path: the peel on the card did not recover the file exactly")
    host_ok, host_bad = sess256.decode(sym_ok, present_ok), sess256.decode(sym_bad, present_bad)
    if host_ok is None or (rec_bad is None) != (host_bad is None):
        raise RuntimeError("receive path: the peel on the card and the host peel disagree")
    rx = {"geometry": "1920x1080 UYVY jpeg q80 " + FEC, "launches": rx_launches,
          "jpeg_bytes": int(file_r.size), "symbol_size": desc.symbol_size,
          "loss_recovered": LOSS_RECOVERED, "rounds_recovered": rounds_ok,
          "loss_unrecoverable": LOSS_UNRECOVERABLE, "rounds_unrecoverable": rounds_bad,
          "unrecoverable_is_none_on_both": rec_bad is None and host_bad is None}
    # the reverse product: torch.matmul on the card against the plain chain
    dec_g = dec_r.decoder
    packed = entropy_decode_422_packed(bytes(file_r))
    if packed is None:
        raise RuntimeError("receive path: the 1080p file has more exceptions than the packed upload takes")
    hdr, lo, dc, exc_idx, exc_dv, count, nmcux, nmcuy = packed
    q = packed_coefficients(*(torch.as_tensor(a).to(dev) for a in (lo, dc, exc_idx[:count].astype(np.int64),
                                                                  exc_dv[:count])), nmcux * nmcuy)
    prod = dec_g.reverse_product(hdr)
    nd_prod, err_prod = byte_diff(dec_g.uyvy_rows(prod(q), nmcux, nmcuy),
                                  dec_g.uyvy_rows(prod.plain(q), nmcux, nmcuy))
    if err_prod > 1 or nd_prod > MAX_DIFF_BYTE_SHARE * q.shape[0] * 256:
        raise RuntimeError(f"reverse product: {nd_prod} bytes differ from the chain (max {err_prod})")
    rx["product_bytes_differing_from_chain"] = nd_prod
    # each output against the CPU plain path, and the PSNR to the source
    # 4:2:0 needs whole 16-row MCUs: 1920x1088
    enc420 = JpegEncoder(W1080, 1088, subsampling="420")
    src420 = frame_for(enc420, 12)
    cases = [("422 UYVY", src, file_r, Codec.UYVY, out),
             ("420 UYVY 1920x1088", src420, enc420.encode(src420), Codec.UYVY, None),
             ("422 RGB", src, file_r, Codec.RGB, None)]
    rx["outputs"] = []
    for what, src_c, fl, codec, got in cases:
        frame_j = VideoFrame(desc_j.with_(height=src_c.shape[0]), [fl])
        if got is None:
            got = dec_r.decompress(frame_j, codec)
        got = got.data
        want = dec_cpu.decompress(frame_j, codec).data
        if not got.is_cuda or got.shape != want.shape:
            raise RuntimeError(f"receive {what}: {got.device} {tuple(got.shape)} vs {tuple(want.shape)}")
        nd, err = byte_diff(got, want)
        row = {"case": what, "bytes_differing_from_cpu": nd, "max_abs_err": err}
        if err > 1 or nd > MAX_DIFF_BYTE_SHARE * want.numel():
            raise RuntimeError(f"receive {what}: {nd} bytes differ from the CPU plain path (max {err})")
        if codec == Codec.UYVY:
            p_gpu, p_cpu = psnr(got.cpu(), src_c.cpu()), psnr(want, src_c.cpu())
            if abs(p_gpu - p_cpu) > 0.01 or not np.isfinite(p_gpu):
                raise RuntimeError(f"receive {what}: PSNR {p_gpu} dB vs CPU {p_cpu} dB")
            row.update(psnr_db=p_gpu, psnr_cpu_db=p_cpu)
        rx["outputs"].append(row)
    rx["card_decode"] = card_decode_rows(dev)
    emit({"phase": "receive_path", **rx})

    # ---- batch: B frames stacked row-wise through BatchedJpegLdgmPipeline,
    # one K1 and one K2 launch per batch (counts set to 0 just before, read
    # just after); each frame's slots, bits and parity equal the
    # single-frame EncodePipeline's on the card, its file the single-frame
    # file; the batched K2 equals its plain version ----
    from ultragrid_tpu_torch.models.encode import BatchedJpegLdgmPipeline

    batch_cases, batches = [], {}
    k2_batch_err = 0
    for label, w, h, nb, sub in BATCHES:
        desc_b = VideoDesc(w, h, Codec.UYVY, 60.0)
        bp = BatchedJpegLdgmPipeline(desc_b, nb, fec=FEC, subsampling=sub, device=dev)
        sp = EncodePipeline(desc_b, EncodeConfig(compress="jpeg", subsampling=sub, fec=FEC), device=dev)
        ls = vc_get_linesize(w, Codec.UYVY)
        frames = torch.as_tensor(np.concatenate([content(h, ls, 30 + i) for i in range(nb)])).to(dev)
        torch.cuda.synchronize()
        jpeg_cuda.LAUNCHES.reset()
        fec_ops.LAUNCHES.reset()
        outs_b = bp(frames)
        torch.cuda.synchronize()
        bl = {"jpeg_encode": jpeg_cuda.LAUNCHES.count, "gf2_parity": fec_ops.LAUNCHES.count}
        if bl != {"jpeg_encode": 1, "gf2_parity": 1}:
            raise RuntimeError(f"batch {label}: launches per batch {bl}, expected one K1 and one K2")
        if bool(outs_b[-1]):
            raise RuntimeError(f"batch {label}: overflow")
        e1 = sp.jpeg_encoder
        ny, nc = e1.nmcu * e1.ky, e1.nmcu
        for i in range(nb):
            ref = sp(frames[i * h: (i + 1) * h])
            got = (outs_b[0][i * ny: (i + 1) * ny], outs_b[1][i * ny: (i + 1) * ny],
                   outs_b[2][i * nc: (i + 1) * nc], outs_b[3][i * nc: (i + 1) * nc],
                   outs_b[4][i * nc: (i + 1) * nc], outs_b[5][i * nc: (i + 1) * nc], outs_b[6][i])
            if not all(torch.equal(g, r) for g, r in zip(got, ref[:7])):
                raise RuntimeError(f"batch {label}: frame {i} differs from the single-frame step")
        par_k = bp.parity(*outs_b[:6])
        par_p = bp.parity.plain(*outs_b[:6])
        k2_batch_err = max(k2_batch_err, max_abs_err([par_k], [par_p]))
        if not torch.equal(par_k, par_p):
            raise RuntimeError(f"batch {label}: batched K2 differs from its plain version")
        files_b = bp.enc.encode(frames)
        if any(not np.array_equal(fb, e1.encode(frames[i * h: (i + 1) * h])) for i, fb in enumerate(files_b)):
            raise RuntimeError(f"batch {label}: a file differs from the single-frame encode")
        batches[label] = (bp, frames, outs_b)
        batch_cases.append({"batch": f"{label} {w}x{h} x{nb} UYVY q80 {e1.subsampling} {FEC}",
                            "launches_per_batch": bl, "frames_equal_single_step": True,
                            "files_equal_single_encode": True, "batched_k2_equals_plain": True,
                            "jpeg_bytes": [int(f.size) for f in files_b[:2]]})
    emit({"phase": "batch", "max_abs_err": k2_batch_err, "cases": batch_cases})

    # ---- pixfmt: every registered conversion at 1920x1080 on the card
    # against the CPU plain path (integer math: byte-equal) ----
    from ultragrid_tpu_torch.ops import dxt, pixfmt

    rng_c = np.random.default_rng(40)
    pairs = pixfmt.conversion_pairs()
    for a_c, b_c in pairs:
        src_c = rng_c.integers(0, 256, (H1080, vc_get_linesize(W1080, a_c)), dtype=np.uint8)
        got = pixfmt.convert_frame(torch.as_tensor(src_c).to(dev), W1080, a_c, b_c)
        want = pixfmt.convert_frame(torch.as_tensor(src_c), W1080, a_c, b_c)
        if not got.is_cuda or got.shape != want.shape or byte_diff(got, want)[0]:
            raise RuntimeError(f"pixfmt {a_c.name}->{b_c.name}: the card differs from the CPU plain path")
    emit({"phase": "pixfmt", "geometry": f"{W1080}x{H1080}", "pairs": len(pairs), "bytes_differing": 0})

    # ---- dxt: each encoder and both decoders at 1080p on the card against
    # the CPU plain path: differing blocks (<= 0.1%) and the decoded PSNR
    # to the source on both (within 0.01 dB) ----
    rgb_np = content(H1080, 3 * W1080, 41)
    uy_np = content(H1080, 2 * W1080, 42)
    uy_rgb = pixfmt.convert_frame(torch.as_tensor(uy_np), W1080, Codec.UYVY, Codec.RGB)
    # DXT1_YUV's source: per pixel (Y, Cb, Cr), chroma repeated
    uy_yuv = torch.as_tensor(np.stack([uy_np[:, 1::2], np.repeat(uy_np[:, 0::4], 2, axis=1),
                                       np.repeat(uy_np[:, 2::4], 2, axis=1)], axis=-1).reshape(H1080, 3 * W1080))
    dxt_cases = []
    nblk = W1080 * H1080 // 16
    for enc_name, src_np, ref_src, bpb in (("dxt1_encode_rgb", rgb_np, torch.as_tensor(rgb_np), 8),
                                       ("dxt1_encode_uyvy", uy_np, uy_rgb, 8),
                                       ("dxt1_yuv_encode_uyvy", uy_np, uy_yuv, 8),
                                       ("dxt5_ycocg_encode_rgb", rgb_np, torch.as_tensor(rgb_np), 16),
                                       ("dxt5_ycocg_encode_uyvy", uy_np, uy_rgb, 16)):
        enc_fn = getattr(dxt, enc_name)
        dec_fn = dxt.dxt1_decode_rgb if bpb == 8 else dxt.dxt5_ycocg_decode_rgb
        got = enc_fn(torch.as_tensor(src_np).to(dev), W1080)
        want = enc_fn(torch.as_tensor(src_np), W1080)
        nd = blocks_differing(got, want, bpb)
        dec_g, dec_c = dec_fn(got, W1080, H1080), dec_fn(want, W1080, H1080)
        if not torch.equal(dec_fn(want.to(dev), W1080, H1080).cpu(), dec_c):
            raise RuntimeError(f"dxt {enc_name}: the decoder on the card differs from the CPU plain path")
        p_g, p_c = psnr(dec_g.cpu(), ref_src), psnr(dec_c, ref_src)
        if nd > MAX_DIFF_BLOCK_SHARE * nblk or abs(p_g - p_c) > 0.01:
            raise RuntimeError(f"dxt {enc_name}: {nd} blocks differ, PSNR {p_g} vs {p_c} dB")
        dxt_cases.append({"encoder": enc_name, "blocks": nblk, "differing_blocks": nd,
                          "psnr_db": p_g, "psnr_cpu_db": p_c, "decoder_bytes_differing": 0})
    emit({"phase": "dxt", "geometry": f"{W1080}x{H1080}", "cases": dxt_cases})

    # ---- encode_variants: EncodePipeline for compress none / dxt1 / dxt5
    # with LDGM and RS at 1080p against the CPU plain path; the fixed-size
    # LDGM parity against the host LdgmSession's; scale_to 1280x720 ----
    var_cases = []
    for comp, inc, work in (("none", Codec.UYVY, Codec.RGB), ("dxt1", Codec.UYVY, Codec.RGB),
                            ("dxt5", Codec.RGB, Codec.RGB)):
        frame_v = content(H1080, vc_get_linesize(W1080, inc), 43)
        for spec in (FEC, "rs:200:240"):
            desc_v = VideoDesc(W1080, H1080, inc, 60.0)
            cfg_v = EncodeConfig(in_codec=inc, work_codec=work, compress=comp, fec=spec)
            pg = EncodePipeline(desc_v, cfg_v, device=dev)
            torch.cuda.synchronize()
            fec_ops.LAUNCHES.reset()
            data_g, par_g = pg(torch.as_tensor(frame_v).to(dev))
            torch.cuda.synchronize()
            k2_launches = fec_ops.LAUNCHES.count
            data_c, par_c = EncodePipeline(desc_v, cfg_v, device="cpu")(frame_v)
            nd_data, _ = byte_diff(data_g, data_c)
            if nd_data > (MAX_DIFF_BLOCK_SHARE * data_c.numel() if comp != "none" else 0):
                raise RuntimeError(f"{comp} {spec}: payload on the card differs from the CPU plain path")
            row = {"case": f"{W1080}x{H1080} {inc.name} {comp} {spec}", "payload_bytes": int(data_c.numel()),
                   "payload_bytes_differing": nd_data, "k2_launches": k2_launches}
            if nd_data == 0 and not torch.equal(par_g.cpu(), par_c):
                raise RuntimeError(f"{comp} {spec}: parity on the card differs from the CPU plain path")
            if spec == FEC:
                if k2_launches != 1:
                    raise RuntimeError(f"{comp} {spec}: {k2_launches} K2 launches, expected 1")
                buf_h, d_h = LdgmSession(256, 26, 5).encode(data_g.cpu().numpy())
                if not np.array_equal(buf_h[256 * d_h.symbol_size:].reshape(26, -1), par_g.cpu().numpy()):
                    raise RuntimeError(f"{comp} {spec}: parity differs from the host LdgmSession's")
                row["parity_equals_host_ldgm_session"] = True
            var_cases.append(row)
    cfg_s = EncodeConfig(compress="jpeg", fec=FEC, scale_to=(1280, 720))
    ps_g = EncodePipeline(desc1080, cfg_s, device=dev)
    torch.cuda.synchronize()
    jpeg_cuda.LAUNCHES.reset()
    fec_ops.LAUNCHES.reset()
    outs_s = ps_g(frame)
    torch.cuda.synchronize()
    sl_launches = {"jpeg_encode": jpeg_cuda.LAUNCHES.count, "gf2_parity": fec_ops.LAUNCHES.count}
    outs_sc = EncodePipeline(desc1080, cfg_s, device="cpu")(frame_np)
    nd_s = differing_blocks([o.cpu() for o in outs_s[:6]], outs_sc[:6])
    if min(sl_launches.values()) < 1 or nd_s or not torch.equal(outs_s[6].cpu(), outs_sc[6]):
        raise RuntimeError(f"scale_to: {sl_launches}, {nd_s} blocks differ from the CPU plain path")
    var_cases.append({"case": "1920x1080 UYVY -> scale_to 1280x720 -> jpeg q80 " + FEC, "launches": sl_launches,
                      "differing_blocks": nd_s, "parity_equal": True})
    emit({"phase": "encode_variants", "cases": var_cases})

    # ---- slice 5: postprocess, filters, the local loop (no hand kernel on
    # this path: the filters and postprocess are plain PyTorch) ----
    emit(phase_postprocess(dev))
    emit(phase_filters(dev))
    emit(phase_local_loop(dev))
    emit(phase_h264(dev))
    emit(phase_codecs(dev))
    live = phase_live_session(dev)
    emit(live)
    assembled = phase_assemble(dev)
    emit(assembled)
    audio = phase_audio_session(dev)
    emit(audio)

    # ---- timing: mean of back-to-back launches between two CUDA events;
    # profiler device time beside it ----
    rows_t = []
    k1_t = {}
    for label, (w, h) in (("1080p", (W1080, H1080)), ("4K", (W4K, H4K)), ("8K", (W8K, H8K))):
        e = JpegEncoder(w, h)
        f = frame_for(e, 4)
        b, ops = k1_work(e)
        bms, by = bound_ms(b, ops)
        ms = cuda_ms(lambda: e._encode(f))
        dms = kernel_device_ms(lambda: e._encode(f), "jpeg_encode_kernel")
        pms = cuda_ms(lambda: e.encode_plain(f), runs=PLAIN_RUNS, warmup=1)
        k1_t[label] = {"ms": ms, "device_ms": dms, "plain_ms": pms, "bound_ms": bms, "bound_by": by}
        rows_t.append({"what": f"K1 jpeg_encode {label} UYVY q80", **k1_t[label],
                       "share_of_bound": bms / dms, "gflop": ops / 1e9, "mbytes": b / 1e6})
    k2_t = {}
    for label, p in (("1080p", pipe), ("8K", pipe8)):
        parts = k2_parts[label]
        b, ops = k2_work(p.parity)
        bms, by = bound_ms(b, ops)
        ms = cuda_ms(lambda: p.parity(*parts))
        dms = kernel_device_ms(lambda: p.parity(*parts), "gf2_parity_kernel")
        pms = cuda_ms(lambda: p.parity.plain(*parts), runs=PLAIN_RUNS, warmup=1)
        k2_t[label] = {"ms": ms, "device_ms": dms, "plain_ms": pms, "bound_ms": bms, "bound_by": by}
        rows_t.append({"what": f"K2 gf2_parity {label} container", **k2_t[label],
                       "share_of_bound": bms / dms, "mbytes": b / 1e6})
    f8 = frame_for(pipe8.jpeg_encoder, 6)
    for label, p, f in (("1080p", pipe, frame), ("8K", pipe8, f8)):
        ks = device_kernels(lambda: p(f), runs=20, expect="jpeg_encode_kernel")
        launches_step, device_step = per_step(ks, "jpeg_encode_kernel")
        rows_t.append({"what": f"EncodePipeline {label} jpeg q80 {FEC}",
                       "ms": cuda_ms(lambda: p(f)),
                       "device_ms": device_step,
                       "launches_per_step": launches_step,
                       "kernels": {n[:60]: [c, ms] for n, (c, ms) in ks.items()},
                       "plain_ms": cuda_ms(lambda: plain_step(p, f), runs=PLAIN_RUNS, warmup=1)})
    # the receive step: host scan decode, upload, device decode, peel
    peel_t = {}
    for label in ("1080p", "8K"):
        data = bytes(files[label][1])
        dec = JpegDecoder(dev)
        packed = entropy_decode_422_packed(data)
        lo, dc, exc_idx, exc_dv = packed[1], packed[2], packed[3][:4096], packed[4][:4096]

        def upload():
            for a in (lo, dc, exc_idx, exc_dv):
                torch.as_tensor(a).to(dev)
            torch.cuda.synchronize()

        def decode():
            dec.decode_to_uyvy(data)
            torch.cuda.synchronize()

        ks = device_kernels(lambda: dec.decode_to_uyvy(data), runs=10, expect="gemm")
        copies = {n: v for n, v in ks.items() if n.lower().startswith("memcpy")}
        kernels = {n: v for n, v in ks.items() if n not in copies}
        launches_d, device_d = per_step(kernels, "gemm")
        scale = launches_d / sum(c for c, _ in kernels.values())
        buf, desc = sess256.encode(files[label][1])
        sym, present = lose(buf, desc.symbol_size, LOSS_RECOVERED, LOSS_RECOVERED)
        sym_d = torch.as_tensor(sym).to(dev)
        sess256.decode_device(sym_d, present)
        rounds = sess256.rounds
        peel_ks = device_kernels(lambda: sess256.decode_device(sym_d, present), runs=10, expect="gf2_parity_kernel")
        launches_p, device_p = per_step(peel_ks, "gf2_parity_kernel", times=rounds)
        rows_t.append({
            "what": f"receive {label} jpeg q80 4:2:2 -> UYVY, {FEC} with {LOSS_RECOVERED} lost",
            "jpeg_bytes": len(data),
            "host_scan_decode_ms": host_ms(lambda: entropy_decode_422_packed(data), runs=10),
            "upload_ms": host_ms(upload, runs=10),
            "decode_to_uyvy_ms": host_ms(decode, runs=10),
            "device_ms": device_d, "device_launches": launches_d,
            "copy_ms": sum(ms for _, ms in copies.values()) * scale,
            "device_kernels": {n[:60]: [c * scale, ms * scale] for n, (c, ms) in kernels.items()},
            "peel_ms": host_ms(lambda: sess256.decode_device(sym_d, present), runs=10),
            "peel_rounds": rounds, "peel_device_ms": device_p, "peel_device_launches": launches_p,
        })
        # K2 without the staircase on the peel's first-round input
        words = symbol_words(torch.where(torch.as_tensor(present, device=dev)[:, None], sym_d, 0))
        par = sess256.peel_parity(dev)[0].with_width(words.shape[1])
        b, ops = k2_peel_work(par)
        bms, by = bound_ms(b, ops)
        ks = device_kernels(lambda: par(words), expect="gf2_parity_kernel")
        hits = [(n, v) for n, v in ks.items() if "gf2_parity_kernel" in n]
        if not hits:
            raise RuntimeError(f"profiler saw no gf2_parity_kernel kernel (saw {sorted(ks)})")
        variant, (count, dms) = hits[0]
        dms /= count
        peel_t[label] = {"ms": cuda_ms(lambda: par(words)), "device_ms": dms, "kernel": variant[:48],
                         "plain_ms": cuda_ms(lambda: par.plain(words), runs=PLAIN_RUNS, warmup=1),
                         "bound_ms": bms, "bound_by": by, "launches_per_decode": rounds}
        rows_t.append({"what": f"K2 gf2_parity without staircase, {label} peel block "
                               f"[{par.rows}, {par.psw}] words", **peel_t[label],
                       "share_of_bound": bms / dms, "mbytes": b / 1e6})
    # the batched sender: frames/s of the device half as bench.py measures
    # it (B over the event-timed batch step, back-to-back batches, bench.py's
    # content: one frame repeated), with and without the per-frame LDGM
    # parity; the batched K2 against its byte bound
    batch_t = {}
    for label, w, h, nb, sub in BATCHES[:2]:
        bp, _, _ = batches[label]
        base = torch.as_tensor(np.concatenate([content(h, vc_get_linesize(w, Codec.UYVY), 0)] * nb)).to(dev)
        outs_t = bp(base)
        k1_ms = cuda_ms(lambda: bp.enc.tall._encode(base), runs=20)
        step_ms = cuda_ms(lambda: bp(base), runs=20)
        ks = device_kernels(lambda: bp(base), runs=10, expect="jpeg_encode_kernel")
        launches_b, device_b = per_step(ks, "jpeg_encode_kernel")
        b_k2, ops_k2 = k2_work(bp.parity)
        bms, by = bound_ms(b_k2, ops_k2)
        k2_dms = kernel_device_ms(lambda: bp.parity(*outs_t[:6]), "gf2_parity_kernel", runs=10)
        batch_t[label] = {
            "frames": nb, "frames_per_s_jpeg": nb / (k1_ms / 1e3), "frames_per_s_jpeg_ldgm": nb / (step_ms / 1e3),
            "batch_ms_jpeg": k1_ms, "batch_ms_jpeg_ldgm": step_ms, "device_ms": device_b,
            "device_launches_per_batch": launches_b,
            "k1_only_bound_frames_per_s": 1e3 / k1_t["4K"]["device_ms"] if label == "4K" else None,
            "k2": {"launches_per_batch": 1, "ms": cuda_ms(lambda: bp.parity(*outs_t[:6]), runs=20),
                   "device_ms": k2_dms, "bound_ms": bms, "bound_by": by, "share_of_bound": bms / k2_dms,
                   "plain_ms": cuda_ms(lambda: bp.parity.plain(*outs_t[:6]), runs=2, warmup=1),
                   "mbytes": b_k2 / 1e6}}
        rows_t.append({"what": f"batch {label} {w}x{h} x{nb} UYVY jpeg q80 (+ {FEC})", **batch_t[label]})
    # single-frame 4K latency (bench.py:111-141): host clock around one
    # K1 launch and a synchronisation
    e4 = JpegEncoder(W4K, H4K)
    f4 = torch.as_tensor(content(H4K, vc_get_linesize(W4K, Codec.UYVY), 0)).to(dev)
    e4._encode(f4)
    torch.cuda.synchronize()
    lats = []
    for _ in range(LATENCY_RUNS):
        t0 = time.perf_counter()
        e4._encode(f4)
        torch.cuda.synchronize()
        lats.append((time.perf_counter() - t0) * 1e3)
    lats.sort()
    latency = {"p50_ms": lats[len(lats) // 2], "p99_ms": lats[min(len(lats) - 1, int(len(lats) * 0.99))]}
    rows_t.append({"what": "latency 4K UYVY jpeg q80, one frame", **latency})
    # conversions (BASELINE configs 1-2), DXT (config 3) and the 1080p
    # compress="none" + LDGM step: profiler device time and launches
    conv_t = []
    for label, (w, h), a_c, b_c in (("1080p", (W1080, H1080), Codec.UYVY, Codec.RGB),
                                    ("4K", (W4K, H4K), Codec.v210, Codec.RG48),
                                    ("4K", (W4K, H4K), Codec.R10k, Codec.Y416)):
        src_t = torch.as_tensor(np.random.default_rng(44).integers(
            0, 256, (h, vc_get_linesize(w, a_c)), dtype=np.uint8)).to(dev)
        conv_t.append(profile_row(f"convert {label} {a_c.name}->{b_c.name}",
                                  lambda: pixfmt.convert_frame(src_t, w, a_c, b_c)))
    uy_d = torch.as_tensor(uy_np).to(dev)
    rgb_d = torch.as_tensor(rgb_np).to(dev)
    conv_t.append(profile_row("dxt1 1080p from UYVY", lambda: dxt.dxt1_encode_uyvy(uy_d, W1080)))
    conv_t.append(profile_row("dxt5 1080p from RGB", lambda: dxt.dxt5_ycocg_encode_rgb(rgb_d, W1080)))
    pn = EncodePipeline(desc1080, EncodeConfig(compress="none", fec=FEC), device=dev)
    conv_t.append(profile_row(f"EncodePipeline 1080p UYVY->RGB none {FEC}", lambda: pn(frame)))
    for r in conv_t:
        r["idle_share"] = max(0.0, 1 - r["device_ms"] / r["host_ms"])
    rows_t += conv_t
    plane_t = plane_entry_timing(dev)
    rows_t += plane_t
    emit({"phase": "timing", "card": smi, "rows": rows_t})
    # slice 10's phase, after the timing rows, so that they are taken as in
    # the earlier slices
    std = phase_standards(dev)
    emit(std)
    # the multi-device path at 8K x 4 bands, its counts
    # read around its own sender and receiver steps
    par = phase_parallel(dev)
    emit(par)
    # the bench tools and the remaining captures, their counts read per tool
    tools = phase_tools(dev)
    emit(tools)
    # the last slice: windowed display, translator, convert, libavcodec, ~/.ug.rc
    rem = phase_remaining(dev)
    emit(rem)
    # the names that close the public API: warm(), jpeg_encode_core, the lavc lists
    api = phase_api(dev)
    emit(api)

    one_call = "none: no single PyTorch call computes this function"
    live_l = live["jpeg_ldgm_1080p"]["launches"]
    audio_l = audio["jpeg_ldgm_audio_1080p"]["launches"]
    replay_l = audio["record_replay"]["replay"]["launches"]
    duplex_l = std["duplex"]["video"]["launches"]
    emit({"kernels": [
        {"name": "jpeg_encode", "route": "cuda", "source": "ultragrid_tpu_torch/csrc/jpeg_encode.cu",
         "replaces": "ultragrid_tpu/ops/jpeg_pallas.py:122", "launches": live_l["jpeg_encode"],
         "launches_on": "live session 1080p jpeg + LDGM, " + str(LIVE_FRAMES) + " frames; "
                        "launches_audio_session: the same with audio (-s testcard -f A:rs:16:24); "
                        "launches_replay_session: -I of a 30-frame -E recording, jpeg + LDGM; "
                        "launches_standards_session: --rtp-standard 1080p jpeg, " + str(STD_FRAMES) + " frames; "
                        "launches_rtsp_capture: the --rtsp sender while RtspCapture took " + str(STD_FRAMES) +
                        " frames; launches_duplex: the duplex call through cli.main, " + str(DUPLEX_FRAMES) +
                        " frames; launches_thumbnails: -F preview and thumbnailgen's " + str(THUMBNAILS) +
                        " thumbnails (960x544 RGB 4:4:4); launches_sharded_sender / launches_sharded_receiver: "
                        "one 8K x 4-band sender step and one receiver step (phase parallel); "
                        "launches_tools: each bench tool's run in phase tools (bench_latency's sender; "
                        "its receiver child uncounted); launches_remaining: phase remaining's 1080p60 jpeg + "
                        "LDGM session into -d x11 (" + str(REM_FRAMES) + " frames) and hd_rum_translator's "
                        "-c jpeg client (" + str(REM_XLATE_FRAMES) + " frames); launches_api: phase api "
                        "(warm() and the escalated 1080p q95 encodes, jpeg_encode_core and its profile)",
         "launches_sender_step": launches["jpeg_encode"],
         "launches_audio_session": audio_l["jpeg_encode"], "launches_replay_session": replay_l["jpeg_encode"],
         "launches_standards_session": std["standards_session"]["launches"]["jpeg_encode"],
         "launches_rtsp_capture": std["rtsp_jpeg"]["launches"]["jpeg_encode"],
         "launches_duplex": duplex_l["jpeg_encode"],
         "launches_thumbnails": std["preview"]["launches"]["jpeg_encode"],
         "launches_sharded_sender": par["launches_sharded_sender"]["jpeg_encode"],
         "launches_sharded_receiver": par["launches_sharded_receiver"]["jpeg_encode"],
         "launches_tools": tools["launches"]["jpeg_encode"],
         "launches_remaining": rem["launches"]["jpeg_encode"],
         "launches_api": api["launches"]["jpeg_encode"],
         "thumbnail_960x544_rgb": std["preview"]["k1_thumbnail_rgb"],
         "max_abs_err": k1_err, **{key: k1_t["1080p"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "device_ms": k1_t["1080p"]["device_ms"], "library_ms": None, "library": one_call,
         "at": "1920x1080 UYVY q80 4:2:2", "8k": k1_t["8K"],
         "tolerance": "bit-equal under dyadic W in every layout and restart interval; "
                      "real W <= 0.1% of blocks differing"},
        {"name": "jpeg_plane_encode", "route": "cuda", "source": "ultragrid_tpu_torch/csrc/jpeg_encode.cu",
         "replaces": "none: no Pallas kernel (ultragrid_tpu/ops/jpeg_pallas.py:55 supports() refuses these "
                     "geometries); the reference's XLA per-plane stages, ultragrid_tpu/ops/jpeg.py:652-705, "
                     "which raise for them (F4, repaired in the port)",
         "launches": live["loopback_jpeg_444"]["launches"]["jpeg_plane_encode"],
         "launches_on": "--protocol loopback jpeg:80:0:444 1080p, 30 frames; launches_4k60: the same from a "
                        "4K60 camera, 60 frames; launches_api: phase api's 1080p q95 4:4:4 warm() and "
                        "escalated encodes",
         "launches_4k60": live["loopback_jpeg_444_4k60"]["launches"]["jpeg_plane_encode"],
         "launches_api": api["launches"]["jpeg_plane_encode"],
         "max_abs_err": plane_err, **{key: plane_t[0][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "device_ms": plane_t[0]["device_ms"], "library_ms": None, "library": one_call,
         "at": "1920x1080 UYVY q80 4:4:4, frame bytes in -> slots out",
         "geometries": {r["what"]: {k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "share_of_bound")}
                        for r in plane_t},
         "tolerance": "bit-equal to the plain version in every per-plane geometry and restart interval"},
        {"name": "gf2_parity", "route": "cuda", "source": "ultragrid_tpu_torch/csrc/gf2_parity.cu",
         "replaces": "ultragrid_tpu/ops/fec.py:141", "launches": live_l["gf2_parity"],
         "launches_on": "live session 1080p jpeg + LDGM with loss (the receiver's peel); "
                        "launches_h264_live: the 1080p h264 inter + LDGM session with loss; "
                        "launches_codec_live: the 1080p jpegxs and openapv + LDGM sessions with loss; "
                        "launches_audio_session / launches_replay_session: the 1080p jpeg + LDGM session "
                        "with audio, and -I of a recording, with loss; launches_duplex: the 1080p duplex "
                        "call through cli.main, jpeg + LDGM, one data packet of each frame dropped; "
                        "launches_sharded_sender / launches_sharded_receiver: one 8K x 4-band sender step "
                        "(K2 per band) and one receiver step with a data symbol erased per band (the peel's "
                        "rounds per band; phase parallel); launches_tools: each bench tool's run in phase "
                        "tools (bench_northstar's steps; no tool's session loses a packet, so no peel); "
                        "launches_remaining: phase remaining's 1080p60 jpeg + LDGM session with loss into "
                        "-d x11 (the receiver's peel)",
         "launches_h264_live": live["h264_inter_ldgm_1080p"]["launches"]["gf2_parity"],
         "peel_h264_max_abs_err": live["h264_k2_peel"]["max_abs_err"],
         "launches_codec_live": {spec: {"launches": live[f"{spec}_ldgm_1080p"]["launches"]["gf2_parity"],
                                        "frames_sent": live[f"{spec}_ldgm_1080p"]["frames_sent"],
                                        "peel_max_abs_err": live[f"{spec}_ldgm_1080p"]["k2_peel"]["max_abs_err"]}
                                 for spec, _ in CODEC_LIVE},
         "launches_sender_step": launches["gf2_parity"],
         "launches_audio_session": audio_l["gf2_parity"], "launches_replay_session": replay_l["gf2_parity"],
         "launches_duplex": duplex_l["gf2_parity"],
         "launches_sharded_sender": par["launches_sharded_sender"]["gf2_parity"],
         "launches_sharded_receiver": par["launches_sharded_receiver"]["gf2_parity"],
         "launches_tools": tools["launches"]["gf2_parity"],
         "launches_remaining": rem["launches"]["gf2_parity"],
         "k2_band_8k_x4": par["timing"]["k2_band"],
         "max_abs_err": k2_err, **{key: k2_t["1080p"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "device_ms": k2_t["1080p"]["device_ms"], "library_ms": None, "library": one_call,
         "at": "1080p step's parts, LDGM 256:26:5", "8k": k2_t["8K"],
         "receive_launches": rx_launches["gf2_parity"], "peel_max_abs_err": k2_peel_err,
         "peel_1080p": peel_t["1080p"], "peel_8k": peel_t["8K"],
         "batch_max_abs_err": k2_batch_err, "batch_4k_b16": batch_t["4K"]["k2"],
         "batch_8k_b4": batch_t["8K"]["k2"],
         "tolerance": "bit-equal, staircase on and off"},
        {"name": "jpeg_decode", "route": "cuda", "source": "ultragrid_tpu_torch/csrc/jpeg_decode.cu",
         "replaces": "none: no Pallas kernel (the JAX package decodes the scan on the host, "
                     "native/jpeg_scan_decode.c); the port's C scan decode for 4:2:2 streams with restart markers",
         "launches": live_l["jpeg_decode"], "frames_displayed": live["jpeg_ldgm_1080p"]["frames_displayed"],
         "launches_on": "each JPEG receiver to UYVY, one launch a decoded frame, checked >= the frames displayed: "
                        "live session 1080p jpeg + LDGM with loss, " + str(LIVE_FRAMES) + " frames; "
                        "launches_audio_session / launches_replay_session: the 1080p jpeg + LDGM session with "
                        "audio, and -I of a recording; launches_duplex: the 1080p duplex call through cli.main; "
                        "launches_receive_path: phase receive_path's one frame; launches_tools: each bench "
                        "tool's run in phase tools; launches_remaining: phase remaining's -d x11 session and "
                        "translator (not checked: what their displays take decides the route)",
         "launches_audio_session": audio_l["jpeg_decode"],
         "frames_audio_session": audio["jpeg_ldgm_audio_1080p"]["frames_displayed"],
         "launches_replay_session": replay_l["jpeg_decode"],
         "frames_replay_session": audio["record_replay"]["replay"]["frames_displayed"],
         "launches_duplex": duplex_l["jpeg_decode"], "frames_duplex": std["duplex"]["video"]["frames_displayed"],
         "launches_receive_path": rx_launches["jpeg_decode"],
         "launches_tools": tools["launches"]["jpeg_decode"],
         "launches_remaining": rem["launches"]["jpeg_decode"],
         "refused_in_checked_sessions": 0,
         "q_differing_from_c_decoder": sum(r["q_differing"] for r in rx["card_decode"]),
         "q_differing_from_plain": sum(r["q_differing_from_plain"] for r in rx["card_decode"]),
         "pixels_differing_from_c_route": sum(r["pixels_differing_from_c_route"] for r in rx["card_decode"]),
         "ms": rx["card_decode"][0]["card_route_host_ms"], "device_ms": rx["card_decode"][0]["device_ms"],
         "plain_ms": rx["card_decode"][0]["plain_on_card_ms"], "bound_ms": rx["card_decode"][0]["bound_ms"],
         "bound_by": rx["card_decode"][0]["bound_by"], "library_ms": None,
         "library": "none: no PyTorch call decodes Huffman codes",
         "at": rx["card_decode"][0]["what"] + "; ms: the card route's host time a frame, file in -> UYVY rows",
         "4k": {k: rx["card_decode"][1][k] for k in ("device_ms", "bound_ms", "plain_on_card_ms",
                                                     "card_route_host_ms")},
         "tolerance": "q bit-equal to the C decoder's and to the plain version's on every stream; "
                      "pixels bit-equal to the C route"},
        {"name": "jpeg_assemble", "route": "cuda", "source": "ultragrid_tpu_torch/csrc/jpeg_assemble.cu",
         "replaces": "none: no Pallas kernel (the JAX package assembles the scan on the host, "
                     "native/jpeg_assemble.c); the port's C assembly for a JPEG frame on the card",
         "launches": live_l["jpeg_assemble"], "frames_sent": live["jpeg_ldgm_1080p"]["frames_sent"],
         "launches_on": "one call (count pass, scan, write pass) a JPEG frame encoded on the card: live "
                        "session 1080p jpeg + LDGM, " + str(LIVE_FRAMES) + " frames; launches_audio_session / "
                        "launches_replay_session: the same with audio, and -I of a recording; launches_duplex: "
                        "the duplex call through cli.main; launches_standards_session: --rtp-standard 1080p "
                        "jpeg; launches_assemble_session: phase assemble's 1080p60 session, checked one a "
                        "frame sent; launches_api: phase api's encodes",
         "launches_audio_session": audio_l["jpeg_assemble"], "launches_replay_session": replay_l["jpeg_assemble"],
         "launches_duplex": duplex_l["jpeg_assemble"],
         "launches_standards_session": std["standards_session"]["launches"]["jpeg_assemble"],
         "launches_assemble_session": assembled["session"]["launches"]["jpeg_assemble"],
         "launches_api": api["launches"]["jpeg_assemble"],
         "ms": assembled["cases"][0]["host_ms_read_and_write"], "device_ms": assembled["cases"][0]["device_ms"],
         "plain_ms": assembled["cases"][0]["plain_ms"], "bound_ms": assembled["cases"][0]["bound_ms"],
         "bound_by": assembled["cases"][0]["bound_by"], "library_ms": None,
         "library": "none: no PyTorch call packs bits into a byte-stuffed stream",
         "at": assembled["cases"][0]["what"] + "; ms: host time of the count pass, the read and the write pass",
         "geometries": {r["what"]: {k: r[k] for k in ("device_ms", "plain_ms", "bound_ms", "share_of_bound")}
                        for r in assembled["cases"]},
         "tolerance": "byte-equal to the host C assembly in every geometry, quality and first segment"},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
