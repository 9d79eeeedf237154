"""Mamba-2 SSD block (torch counterpart of ``repro/models/ssm.py``).

Per-head scalar A, data-dependent dt (softplus), shared B/C projections
(n_groups=1), a depthwise short conv on (x, B, C) and a gated output.  The
sequence path (prefill) runs the chunked SSD scan through
``kernels.ops.ssd_scan`` (the CUDA kernel on CUDA tensors, its plain
version on CPU ones); the decode step is the O(1) recurrent update in
plain torch, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import ParamDef, ParamDefs, Params, softplus


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state


def ssm_param_defs(cfg: ModelConfig) -> ParamDefs:
    D = cfg.d_model
    d_inner, H, P, N = ssm_dims(cfg)
    if d_inner != H * P:
        raise ValueError(f"d_inner {d_inner} != ssm_heads {H} x "
                         f"ssm_head_dim {P}")
    d_xbc = d_inner + 2 * N
    return {
        "w_in_z": ParamDef((D, d_inner), ("ffn_in", "ssm_inner")),
        "w_in_xbc": ParamDef((D, d_xbc), ("ffn_in", "ssm_inner")),
        "w_in_dt": ParamDef((D, H), ("ffn_in", "ssm_heads")),
        "conv_w": ParamDef((cfg.ssm_conv_width, d_xbc),
                           ("conv_w", "ssm_inner"),
                           scale=cfg.ssm_conv_width ** -0.5),
        "conv_b": ParamDef((d_xbc,), ("ssm_inner",), init="zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), init="const", const=0.0),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "D_skip": ParamDef((H,), ("ssm_heads",), init="ones"),
        "w_out": ParamDef((d_inner, D), ("ssm_inner", "ffn_in")),
        "norm_g": ParamDef((d_inner,), ("ssm_inner",), init="zeros"),
    }


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """Chunked SSD scan through ``kernels.ops.ssd_scan``.  x (b,S,H,P); dt
    (b,S,H) positive and A (H,) negative, both in x's dtype; B, C (b,S,N).
    Returns (y (b,S,H,P), final state (b,H,P,N) f32).  ``dtA = dt * A`` is
    formed in x's dtype, as the JAX package forms it."""
    dtA = dt * A
    s0 = initial_state.float().contiguous() \
        if initial_state is not None else None
    return kernel_ops.ssd_scan(x.contiguous(), dt.contiguous(),
                               dtA.contiguous(), B.contiguous(),
                               C.contiguous(), chunk=chunk, s0=s0)


def _gated_rmsnorm(x, z, g, eps=1e-6):
    dt = x.dtype
    x = x.float() * F.silu(z.float())
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1 + g.float())).to(dt)


def ssm_block(
    cfg: ModelConfig,
    p: Params,
    u: torch.Tensor,                               # (B, S, D)
    *,
    state: Optional[Dict[str, torch.Tensor]] = None,   # {"conv", "ssm"}
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full mamba2 mixer.  With a state and S == 1 it takes the recurrent
    decode step; otherwise the causal conv and the chunked SSD scan.
    Returns (out, new state): the decode step's state is new tensors, the
    cache it was given stays as it was."""
    B, S, D = u.shape
    d_inner, H, P, N = ssm_dims(cfg)
    W = cfg.ssm_conv_width

    z = u @ p["w_in_z"]                     # (B,S,d_inner)
    xbc = u @ p["w_in_xbc"]                 # (B,S,d_inner+2N)
    dt_raw = u @ p["w_in_dt"]               # (B,S,H)
    A = -torch.exp(p["A_log"].float())
    dt = softplus(dt_raw.float() + p["dt_bias"].float())

    if state is not None and S == 1:
        # ---- decode: O(1) recurrent update ------------------------------
        window = torch.cat([state["conv"], xbc], dim=1)        # (B,W,d_xbc)
        xbc_t = torch.einsum("bwc,wc->bc", window, p["conv_w"]) \
            + p["conv_b"]
        xbc_t = F.silu(xbc_t)[:, None]                         # (B,1,d_xbc)
        x, Bm, Cm = torch.split(xbc_t, [d_inner, N, N], dim=-1)
        xh = x.reshape(B, H, P)
        dt1 = dt[:, 0]                                         # (B,H)
        decay = torch.exp(dt1 * A)                             # (B,H)
        s = state["ssm"].float()                               # (B,H,P,N)
        # dt_h x_hp B_n as broadcast products: a three-operand einsum
        # would search a contraction path on the host at every call
        s = s * decay[..., None, None] + (dt1[..., None] * xh.float())[
            ..., None] * Bm[:, 0].float()[:, None, None, :]
        y = torch.einsum("bhpn,bn->bhp", s, Cm[:, 0].float())
        y = y + p["D_skip"].float()[None, :, None] * xh
        y = y.reshape(B, 1, d_inner).to(u.dtype)
        y = _gated_rmsnorm(y, z, p["norm_g"])
        out = y @ p["w_out"]
        return out, {"conv": window[:, 1:] if W > 1 else window[:, :0],
                     "ssm": s}

    # ---- prefill: depthwise causal conv + chunked SSD ---------------------
    # shifted-slice sum instead of an (B,S,W,d) window gather
    pad = torch.zeros((B, W - 1, xbc.shape[-1]), dtype=xbc.dtype,
                      device=xbc.device)
    xbc_pad = torch.cat([pad, xbc], dim=1)
    conv_acc = sum(xbc_pad[:, w:w + S] * p["conv_w"][w] for w in range(W))
    xbc_c = F.silu(conv_acc + p["conv_b"])
    x, Bm, Cm = torch.split(xbc_c, [d_inner, N, N], dim=-1)
    xh = x.reshape(B, S, H, P)

    init = state["ssm"] if state is not None else None
    y, s_final = ssd_chunked(xh, dt.to(xh.dtype), A.to(xh.dtype), Bm, Cm,
                             min(cfg.ssm_chunk, S), initial_state=init)
    y = y + p["D_skip"][None, None, :, None].to(y.dtype) * xh
    y = y.reshape(B, S, d_inner)
    y = _gated_rmsnorm(y, z, p["norm_g"])
    out = y @ p["w_out"]
    conv_tail = xbc_pad[:, -(W - 1):] if W > 1 else xbc_pad[:, :0]
    return out, {"conv": conv_tail, "ssm": s_final}


def ssm_state_defs(cfg: ModelConfig, batch: int, layers: int) -> ParamDefs:
    d_inner, H, P, N = ssm_dims(cfg)
    d_xbc = d_inner + 2 * N
    W = cfg.ssm_conv_width
    return {
        "conv": ParamDef((layers, batch, W - 1, d_xbc),
                         ("layers", "batch", "conv_w", "ssm_inner"),
                         init="zeros"),
        "ssm": ParamDef((layers, batch, H, P, N),
                        ("layers", "batch", "ssm_heads", "ssm_head_dim",
                         "ssm_state"), init="zeros", dtype="float32"),
    }
