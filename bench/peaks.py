"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Shares are
stated against these; each run prints the card's power limit beside
them."""

BF16_FLOPS = 989e12        # tensor cores, bf16 and fp16
FP32_FLOPS = 67e12         # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # 80 GB HBM3
