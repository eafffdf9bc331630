#!/usr/bin/env python3
"""Where the port's sender step spends its time on one NVIDIA card, and how
the JPEG front end's summation order moves coefficients.

    python3 chip_profile.py [--out DIR]   # repository root; one CUDA card
    python3 chip_profile.py --per-plane [--root DIR]

Two phases, each printing one JSON line; with ``--out`` the full profiler
tables are written to DIR as text.  ``--per-plane`` runs phase ``per_plane``
alone; ``--root DIR`` imports ``ultragrid_tpu_torch`` from the checkout in
DIR (a parent commit unpacked with ``git archive``), so that one call can
time a parent and a change in turns.

- ``profile``: the port's ``EncodePipeline`` (UYVY -> JPEG q80 -> LDGM
  256:26:5) at 1920x1080 and 7680x2160.  For each: CUDA events over 100
  back-to-back calls (mean), the host clock over STEPS back-to-back calls, and
  ``torch.profiler`` device time and launches per step and per kernel over
  STEPS.  The device idle share is 1 - device time / host time, back to
  back.
- ``sum_order``: at 1920x1080 4:2:2 (K = 256) and 1024x512 4:2:0 (K = 512),
  the coefficients round(bytes @ W - const) computed four ways on the same
  frame (the fused multiply-add chain in ascending k that kernel K1 and its
  plain version use; ``torch.matmul`` on the card, i.e. cuBLAS;
  ``torch.matmul`` on the host CPU; float64 on the card).  For each way: the
  coefficients that differ from the chain's, and the blocks whose symbols
  differ from K1's output.
- ``per_plane``: the JPEG geometries without a mega matrix
  (``chip_smoke.PLANE_CASES``: 4:4:4 from UYVY/YUYV and 4:2:2 from RGB/RGBA
  at 1920x1080, 4:4:4 from UYVY at 3840x2160), frame bytes in -> slots out
  (``JpegEncoder._encode``), measured as ``profile`` measures a step.

Like ``chip_smoke.py`` it imports nothing of JAX or of the JAX package; it
exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from chip_smoke import FEC, PLANE_CASES, content, cuda_ms, differing_blocks, emit, nvidia_smi_line

STEPS = 50  # profiled steps per geometry


def kernel_rows(prof, steps: int):
    """(device ms per step, [(kernel, launches per step, ms per step)])
    from the profiler's device-side events; the kernels by time."""
    rows = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((evt.key, evt.count / steps, us / 1000.0 / steps))
    rows.sort(key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows


def profile_step(label, pipe, frame, steps: int, out_dir):
    from torch.profiler import ProfilerActivity, profile

    step_ms = cuda_ms(lambda: pipe(frame))
    for _ in range(3):
        pipe(frame)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        pipe(frame)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1000.0 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            pipe(frame)
        torch.cuda.synchronize()
    device_ms, rows = kernel_rows(prof, steps)
    if out_dir:
        ka = prof.key_averages()
        try:
            table = ka.table(sort_by="self_device_time_total", row_limit=60)
        except (AttributeError, KeyError):
            table = ka.table(sort_by="self_cuda_time_total", row_limit=60)
        path = os.path.join(out_dir, f"profile_{label}.txt")
        with open(path, "w") as f:
            f.write(f"{label}: {steps} steps\n{table}\n")
    return {
        "geometry": label, "step_ms_cuda_events": step_ms,
        "host_ms_back_to_back": host_ms,
        "device_ms_per_step": device_ms if rows else None,
        "launches_per_step": sum(r[1] for r in rows) if rows else None,
        "device_idle_share": (1.0 - device_ms / host_ms) if rows else None,
        "kernels": [{"name": n[:90], "per_step": c, "ms_per_step": ms} for n, c, ms in rows[:12]],
    }


def sum_order(JpegEncoder, Codec, vc_get_linesize, dev):
    out = []
    for (w, h, sub) in ((1920, 1080, None), (1024, 512, "420")):
        enc = JpegEncoder(w, h, in_codec=Codec.UYVY, quality=80, subsampling=sub)
        frame = torch.as_tensor(content(h, vc_get_linesize(w, Codec.UYVY), 1)).to(dev)
        k1 = [o.cpu() for o in enc._encode(frame)]
        q_chain = enc.front_end(frame)
        W = torch.as_tensor(enc.state["W"], device=dev)
        const = torch.as_tensor(enc.state["const"], device=dev)
        x = enc.mcu_bytes(frame).to(torch.float32)
        ways = {
            "fma_chain": q_chain,
            "cublas_matmul": torch.round(x @ W - const).to(torch.int64),
            "cpu_matmul": torch.round(x.cpu() @ W.cpu() - const.cpu()).to(torch.int64).to(dev),
            "float64": torch.round(x.double() @ W.double() - const.double()).to(torch.int64),
        }
        res = {}
        for name, q in ways.items():
            syms = [o.cpu() for o in enc.symbols_and_pack(q, enc.wwords)]
            res[name] = {"coefficients_differing_from_chain": int((q != q_chain).sum()),
                         "blocks_differing_from_k1": differing_blocks(syms, k1)}
        out.append({"geometry": f"{w}x{h} UYVY q80 {enc.subsampling}", "K": int(W.shape[0]),
                    "coefficients": int(q_chain.numel()), "blocks": enc.nblocks, "ways": res})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="directory for the full profiler tables")
    ap.add_argument("--per-plane", action="store_true", help="run phase per_plane alone")
    ap.add_argument("--root", default=None, help="import ultragrid_tpu_torch from this checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False; this needs a CUDA card", file=sys.stderr)
        return 1
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import ultragrid_tpu_torch
    from ultragrid_tpu_torch import get_device
    from ultragrid_tpu_torch.models.encode import EncodeConfig, EncodePipeline
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.types import Codec, VideoDesc, vc_get_linesize

    dev = get_device("cuda")
    smi = nvidia_smi_line()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.per_plane:
        rows = []
        for w, h, cname, sub, q in PLANE_CASES:
            enc = JpegEncoder(w, h, in_codec=Codec[cname], quality=q, subsampling=sub)
            frame = torch.as_tensor(content(h, vc_get_linesize(w, enc.in_codec), 8)).to(dev)
            rows.append(profile_step(f"{w}x{h}_{cname}_{sub}", enc._encode, frame, STEPS, args.out))
        emit({"phase": "per_plane", "card": smi, "package": os.path.dirname(ultragrid_tpu_torch.__file__),
              "steps": STEPS, "rows": rows})
        print(smi, flush=True)
        return 0
    rows = []
    for label, (w, h) in (("1080p", (1920, 1080)), ("8K_7680x2160", (7680, 2160))):
        pipe = EncodePipeline(VideoDesc(w, h, Codec.UYVY, 60.0), EncodeConfig(compress="jpeg", fec=FEC),
                              device=dev)
        frame = torch.as_tensor(content(h, vc_get_linesize(w, Codec.UYVY), 3)).to(dev)
        rows.append(profile_step(label, pipe, frame, STEPS, args.out))
    emit({"phase": "profile", "card": smi, "steps": STEPS, "rows": rows})
    emit({"phase": "sum_order", "card": smi, "cases": sum_order(JpegEncoder, Codec, vc_get_linesize, dev)})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
