"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 40 experts top-8. [hf:ibm-granite/granite-3.0 family]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    top_k=8,
    rope_theta=10000.0,
    mlp_act="silu",
    gated_mlp=True,
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)
