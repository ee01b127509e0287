"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).  Shares of them are stated with the
card's power limit beside them."""

HBM_BYTES_PER_S = 3.35e12      # HBM3
BF16_FLOPS = 989e12            # tensor cores, bfloat16, dense
