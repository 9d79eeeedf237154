"""Plain float32 reference of the pre-norm dense decoder LMs the cells run
(qwen2), from their equations:

  x0 = E[token]
  per layer: h = RMSNorm(x) (x * rsqrt(mean(x^2) + eps) * (1 + gain));
    q, k, v = h Wq + bq, h Wk + bk, h Wv + bv; RoPE (half-split) on q, k at
    positions 0.. with theta; causal softmax(q k^T * hd^-0.5) v, query
    head h reading key-value head h // (H / K); x += attn Wo;
    z = RMSNorm(x); x += silu(z Wg) * (z Wu) Wd
  logits = RMSNorm(x) Wout (Wout = E^T when tied)

Weights arrive as the benchmark made them (bf16, named as the port's flat
dict, layers stacked); every product here is float32 (``Numerics``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.numerics import Numerics

NEG = float("-inf")
LAYER_KEYS = ("ln1/g", "ln2/g", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
              "attn/bq", "attn/bk", "attn/bv", "mlp/w_up", "mlp/w_gate",
              "mlp/w_down")


def rms_norm(x, gain, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + gain)


def rope(x, positions, theta):
    """Half-split rotary embedding of x (B, S, H, hd) at ``positions``
    (S,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions.float()[:, None] * freq[None, :]
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, chunk: int = 1024):
    """q (B, S, H, hd), k/v (B, S, K, hd) -> (B, S, H, hd); queries taken
    ``chunk`` at a time so that the (S x S) scores never exist whole."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qr = q.reshape(B, S, K, G, hd) * hd ** -0.5
    key = torch.arange(S, device=q.device)
    outs = []
    for s0 in range(0, S, chunk):
        s1 = min(S, s0 + chunk)
        s = torch.einsum("bskgh,btkh->bkgst", qr[:, s0:s1], k)
        mask = key[None, :] > torch.arange(s0, s1, device=q.device)[:, None]
        s = s.masked_fill(mask, NEG)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bkgst,btkh->bskgh", p, v))
    return torch.cat(outs, dim=1).reshape(B, S, H, hd)


def layer(arch: dict, num: Numerics, p: Dict[str, torch.Tensor], x,
          positions):
    """One decoder layer on x (B, S, D) f32."""
    B, S, D = x.shape
    H, K, hd = arch["H"], arch["K"], arch["hd"]
    h = rms_norm(x, p["ln1/g"], arch["eps"])
    q = num.mm(h, p["attn/wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = num.mm(h, p["attn/wk"].reshape(D, K * hd)).reshape(B, S, K, hd)
    v = num.mm(h, p["attn/wv"].reshape(D, K * hd)).reshape(B, S, K, hd)
    if arch["qkv_bias"]:
        q, k, v = q + p["attn/bq"], k + p["attn/bk"], v + p["attn/bv"]
    q, k = rope(q, positions, arch["theta"]), rope(k, positions,
                                                   arch["theta"])
    o = causal_attention(q, k, v)
    x = x + num.mm(o.reshape(B, S, H * hd), p["attn/wo"].reshape(H * hd, D))
    z = rms_norm(x, p["ln2/g"], arch["eps"])
    return x + num.mm(F.silu(num.mm(z, p["mlp/w_gate"])) * num.mm(
        z, p["mlp/w_up"]), p["mlp/w_down"])


def layer_weights(W: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights in float32 (an upcast copy of bf16 ones; a
    view, under autograd, of float32 ones)."""
    return {n: W[f"blocks/{n}"][i].float() for n in LAYER_KEYS
            if f"blocks/{n}" in W}


def head(arch: dict, num: Numerics, W, x):
    """Final norm and output projection -> float32 logits."""
    x = rms_norm(x, W["final_ln/g"].float(), arch["eps"])
    out = W["emb/tok"].float().T if arch["tied"] else W["emb/out"].float()
    return num.mm(x, out)


@torch.no_grad()
def sequence_logits(arch: dict, W, tokens: torch.Tensor, at: torch.Tensor,
                    num: Optional[Numerics] = None) -> torch.Tensor:
    """The logits (len(at), V) at positions ``at`` of one sequence
    ``tokens`` (T,), run a layer at a time with that layer's weights upcast
    to float32 (the serve check)."""
    num = num or Numerics()
    x = W["emb/tok"][tokens.long()].float()[None]
    positions = torch.arange(tokens.shape[0], device=tokens.device)
    for i in range(arch["L"]):
        x = layer(arch, num, layer_weights(W, i), x, positions)
    return head(arch, num, W, x[0, at.long()])


def train_loss(arch: dict, num: Numerics, W, tokens, labels,
               remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of (B, S) ``tokens`` against
    ``labels``, differentiable in the float32 weights ``W``; each layer recomputed in the backward when
    ``remat`` (to fit, as the program does; the values are the same)."""
    x = W["emb/tok"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=tokens.device)

    def run(i, x):
        return layer(arch, num, layer_weights(W, i), x, positions)

    for i in range(arch["L"]):
        x = (checkpoint(run, i, x, use_reentrant=False) if remat
             else run(i, x))
    logits = head(arch, num, W, x)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.long().reshape(-1))
