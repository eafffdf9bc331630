#!/usr/bin/env python3
"""Where kernel K1 spends its time, phase by phase, on one NVIDIA card.

    python3 chip_phases.py        # repository root; one CUDA card

Builds a copy of ``csrc/jpeg_encode.cu`` with ``clock64()`` stamps at the
barriers that end each phase of a tile (staging of the raw bytes; gather
into the front end's layout; DC carry plus front end plus the coefficient
store; symbols and pack; slot stores), runs it on 1920x1080 and 7680x2160
UYVY frames, and prints per phase the share of the CTAs' tile cycles, as
thread 0 of every CTA sees them.  A phase ends at a barrier, so its share
includes the wait for the slowest warp.  The stamped copy is built under
``ultragrid_tpu_torch/build/`` and used nowhere else; its outputs are
checked against the plain version.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from chip_smoke import content, emit, nvidia_smi_line

PHASES = ["staging", "gather", "carry+front_end", "pack", "stores"]
# (text that starts the next phase, index of the phase it closes)
MARKS = [
    ("        // ---- gather: x[row][mcu] as f32", 0),
    ("        // ---- DC predictors for a tile inside a segment", 1),
    ("        // ---- symbols + pack", 2),
    ("        // ---- coalesced slot stores", 3),
    ("        // The next tile writes raw and carry", 4),
]


def stamped_source(src: str) -> str:
    src = src.replace("namespace {\n", "__device__ unsigned long long g_phase[8];\n\nnamespace {\n", 1)
    start = "        // ---- raw bytes of the MCU before the tile and of the tile"
    if start not in src:
        raise RuntimeError("phase marks not found in jpeg_encode.cu")
    src = src.replace(start, "        long long t_ = clock64();\n" + start, 1)
    for text, k in MARKS:
        if text not in src:
            raise RuntimeError(f"phase mark {text.strip()!r} not found in jpeg_encode.cu")
        stamp = (f"        if (threadIdx.x == 0) {{ const long long n_ = clock64(); "
                 f"atomicAdd(&g_phase[{k}], (unsigned long long)(n_ - t_)); t_ = n_; }}\n")
        src = src.replace(text, stamp + text, 1)
    src += ('\nextern "C" int ug_phase_read(void* host)\n'
            "{ return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase)); }\n"
            'extern "C" int ug_phase_zero()\n'
            "{ unsigned long long z[8] = {0}; return (int)cudaMemcpyToSymbol(g_phase, z, sizeof(z)); }\n")
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phases: torch.cuda.is_available() is False; this needs a CUDA card", file=sys.stderr)
        return 1
    from ultragrid_tpu_torch import _build, get_device
    from ultragrid_tpu_torch.ops.jpeg import JpegEncoder
    from ultragrid_tpu_torch.types import Codec, vc_get_linesize

    dev = get_device("cuda")
    csrc = os.path.join(os.path.dirname(_build.__file__), "csrc")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    with open(os.path.join(csrc, "jpeg_encode.cu")) as f:
        stamped = os.path.join(tmp, "jpeg_encode_stamped.cu")
        with open(stamped, "w") as g:
            g.write(stamped_source(f.read()))
    srcs = [stamped] + [s for s in sorted(glob.glob(os.path.join(csrc, "*.cu")))
                        if not s.endswith("jpeg_encode.cu")]
    so = os.path.join(tmp, "stamped.so")
    nvcc = [c for c in _build.NVCC_FLAGS if c not in ("-Xptxas", "-v")]
    subprocess.run([_build._nvcc(), *nvcc, "-shared", "-o", so, *srcs], check=True)
    lib = ctypes.CDLL(so)
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.ug_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ug_cuda_error_string.restype = ctypes.c_char_p
    _build.kernels_lib = lambda: lib  # the wrapper launches the stamped copy

    rows = []
    for label, (w, h) in (("1080p", (1920, 1080)), ("8K_7680x2160", (7680, 2160))):
        enc = JpegEncoder(w, h)
        frame = torch.as_tensor(content(h, vc_get_linesize(w, Codec.UYVY), 4)).to(dev)
        want = enc.encode_plain(frame)
        got = enc._encode(frame)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"stamped K1 differs from the plain version at {label}")
        runs = 20
        torch.cuda.synchronize()
        _build.check(lib.ug_phase_zero(), "phase zero")
        for _ in range(runs):
            enc._encode(frame)
        torch.cuda.synchronize()
        cyc = np.zeros(8, np.uint64)
        _build.check(lib.ug_phase_read(cyc.ctypes.data), "phase read")
        total = float(cyc[: len(PHASES)].sum())
        rows.append({"geometry": label, "tiles": -(-enc.nmcu // 16),
                     "share": {p: float(cyc[i]) / total for i, p in enumerate(PHASES)},
                     "cycles_per_tile": {p: float(cyc[i]) / runs / -(-enc.nmcu // 16)
                                         for i, p in enumerate(PHASES)}})
    emit({"phase": "k1_phases", "card": nvidia_smi_line(), "rows": rows})
    return 0


if __name__ == "__main__":
    sys.exit(main())
