"""Config system: model architecture configs, input-shape cells, reduction.

Every architecture is a ``ModelConfig`` in ``repro_torch/configs/<id>.py``;
the registry in ``configs/__init__.py`` resolves ``--arch <id>``.  The
fields and values are the JAX package's own (``repro/configs``), copied so
that the port imports nothing of it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Input-shape cells (same four for every LM-family arch, per assignment).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters + runtime knobs.

    ``family`` controls which block stack is built:
      dense | moe | ssm | hybrid | encdec | vlm
    """

    arch: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    local_window: int = 0           # 0 = global attention
    alt_local_global: bool = False  # gemma2: even layers local, odd global
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    mlp_act: str = "silu"           # silu (SwiGLU) | gelu (GeGLU / plain)
    gated_mlp: bool = True

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (recurrentgemma): block pattern string, e.g. "RRA" tiled
    block_pattern: str = ""
    lru_width: int = 0

    # enc-dec (whisper)
    enc_layers: int = 0
    dec_layers: int = 0

    # vlm stub
    vision_tokens: int = 0

    # runtime knobs
    dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: str = "full"             # none | dots | full
    fsdp: bool = True               # shard params/opt state over data axis
    tie_embeddings: bool = True

    # which shape cells this arch runs (skips documented in DESIGN.md §4)
    skip_shapes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        c = self
        n = c.vocab_size * c.d_model  # embeddings (tied)
        if not c.tie_embeddings:
            n += c.vocab_size * c.d_model
        per_layer = 0
        if c.family == "ssm":
            d_in = c.ssm_expand * c.d_model
            d_xbc = d_in + 2 * c.ssm_state
            per_layer = c.d_model * (d_in + d_xbc + c.ssm_heads)  # in_proj
            per_layer += c.ssm_conv_width * d_xbc                  # conv
            per_layer += d_in * c.d_model                          # out_proj
            per_layer += 3 * c.ssm_heads                           # A, dt_bias, D
            n += c.num_layers * per_layer
            return n
        attn = c.d_model * c.num_heads * c.head_dim * 2
        attn += c.d_model * c.num_kv_heads * c.head_dim * 2
        mlp_in = 2 * c.d_ff if c.gated_mlp else c.d_ff
        if c.is_moe:
            mlp = c.num_experts * (c.d_model * mlp_in + c.d_ff * c.d_model)
            mlp += c.d_model * c.num_experts  # router
        else:
            mlp = c.d_model * mlp_in + c.d_ff * c.d_model
        if c.family == "hybrid":
            # mix of recurrent + attention blocks
            pat = c.block_pattern or "A"
            n_attn = sum(1 for i in range(c.num_layers) if pat[i % len(pat)] == "A")
            n_rec = c.num_layers - n_attn
            rec = c.d_model * c.lru_width * 2 + c.lru_width * c.d_model + 4 * c.lru_width
            n += n_attn * (attn + mlp) + n_rec * (rec + mlp)
            return n
        if c.family == "encdec":
            # encoder: self+mlp, decoder: self+cross+mlp
            n += c.enc_layers * (attn + mlp) + c.dec_layers * (2 * attn + mlp)
            return n
        n += c.num_layers * (attn + mlp)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE uses top_k experts)."""
        if not self.is_moe:
            return self.param_count()
        c = self
        n = c.vocab_size * c.d_model
        attn = c.d_model * (c.num_heads + c.num_kv_heads) * c.head_dim * 2
        mlp_in = 2 * c.d_ff if c.gated_mlp else c.d_ff
        mlp = c.top_k * (c.d_model * mlp_in + c.d_ff * c.d_model)
        return n + c.num_layers * (attn + mlp + c.d_model * c.num_experts)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test-sized config of the same family (CPU-runnable)."""
    small = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        remat="none",
        fsdp=False,
    )
    if cfg.is_moe:
        small.update(num_experts=8, top_k=2, d_ff=64)
    if cfg.family == "ssm":
        small.update(ssm_state=16, ssm_heads=4, ssm_head_dim=32, ssm_chunk=32,
                     num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0)
    if cfg.family == "hybrid":
        small.update(lru_width=64, num_layers=3, local_window=32)
    if cfg.family == "encdec":
        small.update(enc_layers=2, dec_layers=2)
    if cfg.local_window:
        small.update(local_window=min(cfg.local_window, 32))
    if cfg.vision_tokens:
        small.update(vision_tokens=8)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def smoke_shape(kind: str = "train") -> ShapeConfig:
    return ShapeConfig(f"smoke_{kind}", 64, 2, kind)
