"""whisper-tiny [audio]: 4L (enc) + 4L (dec), d_model=384, 6H MHA, d_ff=1536,
vocab=51865. Encoder-decoder; conv audio frontend is a STUB — ``input_specs``
feeds precomputed (B, S, 384) frame embeddings. [arXiv:2212.04356]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch="whisper-tiny",
    family="encdec",
    num_layers=4,          # per-stack depth (enc_layers/dec_layers below)
    enc_layers=4,
    dec_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_act="gelu",
    gated_mlp=False,
    rope_theta=0.0,        # whisper uses absolute positions, not RoPE
    tie_embeddings=True,
    scan_layers=False,     # 4+4 small layers — unrolled
    skip_shapes=("long_500k",),
)
