"""RG-LRU recurrent block (torch counterpart of ``repro/models/rglru.py``;
Griffin / RecurrentGemma, arXiv:2402.19427).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(c * softplus(Lambda) * (-r_t))   with c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Wrapped in the Griffin recurrent block: linear_in -> [gate branch (GeLU)] x
[conv1d(4) -> RG-LRU branch] -> linear_out.  The gates (a, sqrt(1 - a^2)
i x) and the recurrence run as one call, ``kernels.ops.rglru_gated_scan``
(``impl="kernel"``: one CUDA launch on CUDA tensors) or its plain version
(``impl="plain"``), in every mode, the decode step (S = 1) included.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.rglru_scan import rglru_gated_scan_plain
from repro_torch.models.common import ParamDef, ParamDefs, Params

SCAN_IMPLS = ("plain", "kernel")


def rglru_param_defs(cfg: ModelConfig) -> ParamDefs:
    D, R = cfg.d_model, cfg.lru_width
    W = 4  # temporal conv width (fixed in the paper)
    return {
        "w_in_x": ParamDef((D, R), ("ffn_in", "lru")),
        "w_in_gate": ParamDef((D, R), ("ffn_in", "lru")),
        "conv_w": ParamDef((W, R), ("conv_w", "lru"), scale=W ** -0.5),
        "conv_b": ParamDef((R,), ("lru",), init="zeros"),
        "w_a": ParamDef((R, R), ("lru", "ffn_in"), scale=R ** -0.5),
        "b_a": ParamDef((R,), ("lru",), init="zeros"),
        "w_i": ParamDef((R, R), ("lru", "ffn_in"), scale=R ** -0.5),
        "b_i": ParamDef((R,), ("lru",), init="zeros"),
        "lam": ParamDef((R,), ("lru",), init="const", const=1.0),
        "w_out": ParamDef((R, D), ("lru", "ffn_in")),
    }


def rglru_scan(x, r, i, lam, h0: Optional[torch.Tensor] = None, *,
               impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i: (B, S, R); lam: (R,); h0 (B, R) or None.  Returns (y
    (B,S,R) in x's dtype, h_final (B,R) f32).  The gates are formed in f32
    as the JAX package forms them; the recurrence itself is sequential
    (the JAX package's associative scan sums in another order).  Gates and
    recurrence are one call: ``kernels.ops.rglru_gated_scan`` (one launch
    on CUDA tensors) or its plain version."""
    if impl not in SCAN_IMPLS:
        raise ValueError(f"scan impl {impl!r} not in {SCAN_IMPLS}")
    scan = kernel_ops.rglru_gated_scan if impl == "kernel" \
        else rglru_gated_scan_plain
    return scan(x.contiguous(), r.contiguous(), i.contiguous(),
                lam.contiguous(),
                h0.float().contiguous() if h0 is not None else None)


def rglru_block(
    cfg: ModelConfig,
    p: Params,
    u: torch.Tensor,                               # (B, S, D)
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,   # {"h", "conv"}
    impl: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (out, new state {"h": (B,R) f32, "conv": (B,W-1,R)}); the
    state is new tensors, the cache it was given stays as it was."""
    B, S, D = u.shape
    R = cfg.lru_width
    W = p["conv_w"].shape[0]

    gate = F.gelu(u @ p["w_in_gate"], approximate="tanh")     # (B,S,R)
    x = u @ p["w_in_x"]                                       # (B,S,R)

    # depthwise causal conv
    if state is not None and S == 1:
        window = torch.cat([state["conv"], x], dim=1)          # (B,W,R)
        xc = torch.einsum("bwr,wr->br", window, p["conv_w"]) + p["conv_b"]
        xc = xc[:, None]
        conv_tail = window[:, 1:]
    else:
        prev = (state["conv"] if state is not None
                else torch.zeros((B, W - 1, R), dtype=x.dtype,
                                 device=x.device))
        padx = torch.cat([prev, x], dim=1)
        # shifted-slice sum (avoids the (B,S,W,R) window gather)
        xc = sum(padx[:, w:w + S] * p["conv_w"][w] for w in range(W))
        xc = xc + p["conv_b"]
        conv_tail = padx[:, -(W - 1):]

    r = torch.sigmoid(xc @ p["w_a"] + p["b_a"])
    i = torch.sigmoid(xc @ p["w_i"] + p["b_i"])
    h0 = state["h"] if state is not None else None
    y, h_final = rglru_scan(xc, r, i, p["lam"], h0, impl=impl)
    out = (y * gate) @ p["w_out"]
    return out, {"h": h_final, "conv": conv_tail}


def rglru_state_defs(cfg: ModelConfig, batch: int, n_rec: int) -> ParamDefs:
    R, W = cfg.lru_width, 4
    return {
        "h": ParamDef((n_rec, batch, R), ("stack", "batch", "lru"),
                      init="zeros", dtype="float32"),
        "conv": ParamDef((n_rec, batch, W - 1, R),
                         ("stack", "batch", "conv_w", "lru"), init="zeros"),
    }
