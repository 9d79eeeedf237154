"""phi3-mini-3.8b [dense]: 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

RoPE + SwiGLU + (degenerate) GQA == MHA. [arXiv:2404.14219]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    mlp_act="silu",
    gated_mlp=True,
    tie_embeddings=False,
    skip_shapes=("long_500k",),
)
