"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Roofline shares
and utilisations are stated against these, with the card's power limit
beside them in PERF.md."""

BF16_FLOPS_PER_S = 989e12       # bf16 / fp16 tensor cores
HBM_BYTES_PER_S = 3.35e12       # device memory
