"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, no
sparsity, at the full 700 W power limit)."""

BF16_FLOPS = 989e12   # tensor cores, bf16/fp16
BYTES = 3.35e12       # HBM3 bytes/s
