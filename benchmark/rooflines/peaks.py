"""Published peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at its
700 W power limit)."""

FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
