"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit)."""

BF16_FLOPS = 989e12         # tensor cores, bf16 / fp16
HBM_BYTES_S = 3.35e12       # HBM3
