"""Dense (optionally gated) MLP blocks: SwiGLU / GeGLU / plain."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, ParamDefs, Params, activation


def mlp_param_defs(cfg: ModelConfig, d_ff: int = 0) -> ParamDefs:
    D, F = cfg.d_model, d_ff or cfg.d_ff
    defs: ParamDefs = {
        "w_up": ParamDef((D, F), ("ffn_in", "ffn")),
        "w_down": ParamDef((F, D), ("ffn", "ffn_in")),
    }
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((D, F), ("ffn_in", "ffn"))
    return defs


def mlp_block(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    act = activation(cfg.mlp_act)
    up = x @ p["w_up"]
    h = act(x @ p["w_gate"]) * up if cfg.gated_mlp else act(up)
    return h @ p["w_down"]
