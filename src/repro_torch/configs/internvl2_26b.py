"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

InternViT frontend is a STUB — ``input_specs`` provides precomputed patch
embeddings that replace the first ``vision_tokens`` positions; the backbone
(InternLM2-20B-class) is implemented in full. [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1000000.0,
    mlp_act="silu",
    gated_mlp=True,
    vision_tokens=256,
    tie_embeddings=False,
    skip_shapes=("long_500k",),
)
