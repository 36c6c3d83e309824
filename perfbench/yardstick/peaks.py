"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense
rates, without sparsity, at the card's full 700 W power limit)."""

# float32 outside the tensor cores
FP32_FLOPS = 67e12
# TF32 on the tensor cores
TF32_FLOPS = 495e12
# HBM3
HBM_BYTES_S = 3.35e12
# a float32-accurate product on the TF32 tensor cores takes three passes
# (hi.hi + hi.lo + lo.hi)
TF32_PASSES = 3
