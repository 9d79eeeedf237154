"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.

Local(4096)/global alternating attention with logit soft-capping.
[arXiv:2408.00118]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    rope_theta=10000.0,
    local_window=4096,
    alt_local_global=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_act="gelu",
    gated_mlp=True,
    tie_embeddings=True,
    skip_shapes=("long_500k",),  # global layers are full attention
)
