"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (GQA kv=16) d_ff=1408/expert,
vocab=163840, MoE 64 experts top-6 (kimi / Moonlight-16B-A3B).
[hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    top_k=6,
    rope_theta=50000.0,
    mlp_act="silu",
    gated_mlp=True,
    tie_embeddings=False,
    skip_shapes=("long_500k",),
)
