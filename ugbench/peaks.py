"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): the yardstick of every roofline share."""

FP32_FLOPS = 67e12  # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12  # HBM3, bytes/s
