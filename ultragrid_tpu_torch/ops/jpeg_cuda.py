"""Wrappers of kernel K1 (``csrc/jpeg_encode.cu``): the fused JPEG encode,
and its per-plane entry (the same encode for the geometries without a mega
matrix, from the frame's Y, Cb and Cr planes).

Counterpart of ``ultragrid_tpu/ops/jpeg_pallas.py::make_fused_encode``.  The
plain version of both is :meth:`ultragrid_tpu_torch.ops.jpeg.JpegEncoder.encode_plain`;
:meth:`JpegEncoder._encode` calls these wrappers for CUDA tensors only.
"""

from __future__ import annotations

import torch

from ultragrid_tpu_torch import _build

LAUNCHES = _build.LaunchCounter("jpeg_encode")
PLANE_LAUNCHES = _build.LaunchCounter("jpeg_plane_encode")

# layout id -> (bytes per MCU K, columns NC, luma blocks per MCU, MCU rows, bytes per MCU row)
GEOMETRY = {
    0: (256, 256, 2, 8, 32),   # 4:2:2 UYVY/YUYV
    1: (512, 384, 4, 16, 32),  # 4:2:0 UYVY/YUYV
    2: (192, 192, 1, 8, 24),   # 4:4:4 RGB
    3: (256, 192, 1, 8, 32),   # 4:4:4 RGBA
}

# per-plane layout id -> the same fields, for jpeg_plane_encode_kernel
PLANE_GEOMETRY = {
    0: (128, 192, 1, 8, 16),   # 4:4:4 UYVY
    1: (128, 192, 1, 8, 16),   # 4:4:4 YUYV
    2: (384, 256, 2, 8, 48),   # 4:2:2 RGB
    3: (512, 256, 2, 8, 64),   # 4:2:2 RGBA
}


def _expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def _outputs(nmcu: int, ny: int, wwords: int, dev: torch.device):
    """(ys, ybits, us, ubits, vs, vbits, overflow byte) of a K1 launch."""
    def slots(n):
        return torch.empty(n, wwords, dtype=torch.int32, device=dev)

    def bits(n):
        return torch.empty(n, dtype=torch.int32, device=dev)

    return (slots(nmcu * ny), bits(nmcu * ny), slots(nmcu), bits(nmcu), slots(nmcu), bits(nmcu),
            torch.zeros(1, dtype=torch.bool, device=dev))


def fused_encode(frame: torch.Tensor, wc: torch.Tensor, rows: torch.Tensor,
                 groups: torch.Tensor, const: torch.Tensor, huff: torch.Tensor, *,
                 layout: int, nmcux: int, nmcuy: int, restart_interval: int, wwords: int):
    """One launch of K1 over a whole frame.

    frame: uint8 [H, linesize] on a CUDA device; (rows int32 [n], groups
    int32 [blocks per MCU, 3], wc f32 [n_wc, 64]) the plan of
    :func:`ultragrid_tpu_torch.ops.jpeg.support_plan`; const f32 [NC]; huff
    int32 [544] = (code << 5) | length for DC luma[16], DC chroma[16], AC
    luma[256], AC chroma[256].  Returns (ys, ybits, us, ubits, vs, vbits,
    overflow) with the plain path's shapes and dtypes.
    """
    if not frame.is_cuda:
        raise ValueError("fused_encode needs a CUDA tensor; the CPU uses JpegEncoder.encode_plain")
    if layout not in GEOMETRY:
        raise ValueError(f"unknown layout {layout}")
    K, NC, ny, mcu_h, bpr = GEOMETRY[layout]
    dev = frame.device
    if frame.dtype != torch.uint8 or frame.dim() != 2 or not frame.is_contiguous():
        raise ValueError(f"frame: expected contiguous uint8 [H, linesize], got {frame.dtype} {tuple(frame.shape)}")
    if frame.shape[0] != nmcuy * mcu_h or frame.shape[1] < nmcux * bpr:
        raise ValueError(f"frame shape {tuple(frame.shape)} too small for {nmcux}x{nmcuy} MCUs")
    bpm = NC // 64
    _expect(groups, "groups", torch.int32, (bpm, 3), dev)
    _expect(rows, "rows", torch.int32, (rows.shape[0],), dev)
    _expect(wc, "wc", torch.float32, (wc.shape[0], 64), dev)
    _expect(const, "const", torch.float32, (NC,), dev)
    _expect(huff, "huff", torch.int32, (544,), dev)
    if not 1 <= wwords <= 64 or restart_interval < 1:
        raise ValueError(f"bad wwords {wwords} / restart interval {restart_interval}")

    nmcu = nmcux * nmcuy
    ys, ybits, us, ubits, vs, vbits, ovf = _outputs(nmcu, ny, wwords, dev)
    lib = _build.kernels_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ug_jpeg_encode(
            frame.data_ptr(), frame.shape[1], wc.data_ptr(), wc.shape[0],
            rows.data_ptr(), rows.shape[0], groups.data_ptr(), const.data_ptr(),
            huff.data_ptr(), ys.data_ptr(), ybits.data_ptr(), us.data_ptr(),
            ubits.data_ptr(), vs.data_ptr(), vbits.data_ptr(), ovf.data_ptr(),
            layout, nmcux, nmcu, restart_interval, wwords, stream)
    _build.check(err, "jpeg_encode launch")
    LAUNCHES.add(dev)
    return ys, ybits, us, ubits, vs, vbits, ovf[0]


def plane_encode(frame: torch.Tensor, w: torch.Tensor, const: torch.Tensor, huff: torch.Tensor, *,
                 layout: int, nmcux: int, nmcuy: int, restart_interval: int, wwords: int):
    """One launch of K1's per-plane entry over a whole frame: frame bytes in,
    slots out, no coefficient in device memory.

    frame: uint8 [H, linesize] on a CUDA device; w f32 [64, 128] = [my | mc]
    and const f32 [128] of ``JpegEncoder._build_plane_matrices``; huff as
    :func:`fused_encode`; layout a key of :data:`PLANE_GEOMETRY`.  Every
    argument is checked before the device and before any build.  Returns
    (ys, ybits, us, ubits, vs, vbits, overflow) with the plain path's shapes
    and dtypes.
    """
    if layout not in PLANE_GEOMETRY:
        raise ValueError(f"unknown per-plane layout {layout}")
    if not 1 <= wwords <= 64 or restart_interval < 1:
        raise ValueError(f"bad wwords {wwords} / restart interval {restart_interval}")
    _, _, ny, mcu_h, bpr = PLANE_GEOMETRY[layout]
    if frame.dtype != torch.uint8 or frame.dim() != 2 or not frame.is_contiguous():
        raise ValueError(f"frame: expected contiguous uint8 [H, linesize], got {frame.dtype} {tuple(frame.shape)}")
    if frame.shape[0] != nmcuy * mcu_h or frame.shape[1] < nmcux * bpr:
        raise ValueError(f"frame shape {tuple(frame.shape)} too small for {nmcux}x{nmcuy} MCUs")
    dev = frame.device
    _expect(w, "w", torch.float32, (64, 128), dev)
    _expect(const, "const", torch.float32, (128,), dev)
    _expect(huff, "huff", torch.int32, (544,), dev)
    if not frame.is_cuda:
        raise ValueError("plane_encode needs a CUDA tensor; the CPU uses JpegEncoder.encode_plain")

    nmcu = nmcux * nmcuy
    ys, ybits, us, ubits, vs, vbits, ovf = _outputs(nmcu, ny, wwords, dev)
    lib = _build.kernels_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ug_jpeg_plane_encode(
            frame.data_ptr(), frame.shape[1], w.data_ptr(), const.data_ptr(), huff.data_ptr(),
            ys.data_ptr(), ybits.data_ptr(), us.data_ptr(), ubits.data_ptr(), vs.data_ptr(),
            vbits.data_ptr(), ovf.data_ptr(), layout, nmcux, nmcu, restart_interval, wwords, stream)
    _build.check(err, "jpeg_plane_encode launch")
    PLANE_LAUNCHES.add(dev)
    return ys, ybits, us, ubits, vs, vbits, ovf[0]
