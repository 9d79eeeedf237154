"""recurrentgemma-2b [hybrid]: 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention, temporal pattern (R,R,A).

Runs ``long_500k`` (O(1) LRU state, 2048-token local attention window).
[arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    local_window=2048,
    block_pattern="RRA",
    lru_width=2560,
    mlp_act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    scan_layers=False,     # heterogeneous block stack — unrolled
)
