"""mamba2-1.3b [ssm]: 48L d_model=2048, attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality): d_inner = 2*d_model = 4096, 64 heads x headdim 64.
Runs ``long_500k`` (O(1) recurrent state). [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_heads=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
)
