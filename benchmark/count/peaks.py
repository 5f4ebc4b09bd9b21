"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit)."""

BF16_OPS = 989e12      # bf16 / fp16 tensor-core operations a second
HBM_BPS = 3.35e12      # HBM3 bytes a second
