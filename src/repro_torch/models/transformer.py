"""Dense decoder assembly (torch counterpart of the dense-family parts of
``repro/models/transformer.py``).

Modes:
  prefill — full-sequence forward, returns the per-layer KV cache
  decode  — one token per row against an existing cache, at per-row
            positions (the serve tick); the cache is updated in place.
            With a page table the cache is the paged pool, and S > 1
            tokens per row is the paged suffix prefill.

The JAX package scans the stacked layers with ``jax.lax.scan``; here a
Python loop walks views of the same stacked tensors.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (ParamDef, ParamDefs, Params, rms_norm,
                                       rope_tables, softcap, stacked, subtree,
                                       torch_dtype)


def _prefix(pre: str, defs: ParamDefs) -> ParamDefs:
    return {f"{pre}/{k}": v for k, v in defs.items()}


def _decoder_layer_defs(cfg: ModelConfig) -> ParamDefs:
    D = cfg.d_model
    defs: ParamDefs = {"ln1/g": ParamDef((D,), (None,), init="zeros")}
    defs.update(_prefix("attn", attn_mod.attn_param_defs(cfg)))
    defs["ln2/g"] = ParamDef((D,), (None,), init="zeros")
    defs.update(_prefix("mlp", mlp_mod.mlp_param_defs(cfg)))
    return defs


def model_param_defs(cfg: ModelConfig) -> ParamDefs:
    """Parameter defs of the dense decoder, named as ``model.init`` names
    them in the JAX package (stacked layers under ``blocks/``)."""
    D, V = cfg.d_model, cfg.vocab_size
    defs: ParamDefs = {
        "emb/tok": ParamDef((V, D), ("vocab", "embed"), scale=0.02),
        "final_ln/g": ParamDef((D,), (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["emb/out"] = ParamDef((D, V), ("embed", "vocab"),
                                   scale=D ** -0.5)
    defs.update(stacked(_decoder_layer_defs(cfg), cfg.num_layers, "blocks"))
    return defs


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer local-attention window (0 = global)."""
    if cfg.alt_local_global:
        return [cfg.local_window if i % 2 == 0 else 0
                for i in range(cfg.num_layers)]
    return [cfg.local_window] * cfg.num_layers


def cache_param_defs(cfg: ModelConfig, batch: int, max_len: int) -> ParamDefs:
    return attn_mod.cache_defs(cfg, batch, max_len, cfg.num_layers)


def paged_cache_param_defs(cfg: ModelConfig, num_pages: int,
                           page_size: int) -> ParamDefs:
    return attn_mod.paged_cache_defs(cfg, num_pages, page_size,
                                     cfg.num_layers)


def _layers(cfg: ModelConfig, params: Params) -> List[Params]:
    """Per-layer views of the stacked ``blocks/`` tensors."""
    blocks = subtree(params, "blocks")
    return [{n: w[i] for n, w in blocks.items()}
            for i in range(cfg.num_layers)]


def _decoder_layer(cfg: ModelConfig, p: Params, x, *, rope_cs, window,
                   cache=None, cache_pos=None, return_kv=False, impl="plain",
                   page_table=None, kv_write_mask=None):
    """Dense layer body. Returns (x, new_cache)."""
    h, new_cache = attn_mod.attention_block(
        cfg, subtree(p, "attn"), rms_norm(x, p["ln1/g"]),
        rope_cs=rope_cs, window=window, cache=cache,
        cache_pos=cache_pos, return_kv=return_kv, impl=impl,
        page_table=page_table, kv_write_mask=kv_write_mask)
    x = x + h
    m = mlp_mod.mlp_block(cfg, subtree(p, "mlp"), rms_norm(x, p["ln2/g"]))
    return x + m, new_cache


def _embed(cfg: ModelConfig, params: Params, tokens) -> torch.Tensor:
    return params["emb/tok"][tokens].to(torch_dtype(cfg.dtype))


def _unembed(cfg: ModelConfig, params: Params, x) -> torch.Tensor:
    """Final norm + output projection; returns f32 logits (after the
    optional final softcap)."""
    x = rms_norm(x, params["final_ln/g"])
    if cfg.tie_embeddings:
        logits = x @ params["emb/tok"].T
    else:
        logits = x @ params["emb/out"]
    return softcap(logits.float(), cfg.final_softcap)


def decoder_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    mode: str = "prefill",                # prefill | decode
    cache: Optional[Params] = None,       # {"k","v"}: (layers,B,L,K,hd)
    cache_pos: Optional[torch.Tensor] = None,   # decode: (B,) int32
    attn_impl: str = "plain",
    logits_at: Optional[torch.Tensor] = None,   # (B,) token indices
    page_table: Optional[torch.Tensor] = None,  # paged: (B, nb) int32
    kv_write_mask: Optional[torch.Tensor] = None,   # paged suffix: (B, S)
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Returns (logits, cache).

    Prefill returns (B, S, V) logits — or (B, 1, V) at token index
    ``logits_at[b]`` when given, which saves the full (B, S, V) f32 tensor
    (2 GB at llama3-8b, B=8, S=512) when only the last prompt position is
    needed — and the stacked fresh KV.  Decode writes each row's K/V at
    its own ``cache_pos[b]`` into ``cache`` in place and returns (B, 1, V)
    logits with the same cache.  With ``page_table`` the cache is the
    paged pool ``{"k","v"}: (layers, P, ps, K, hd)`` and ``cache_pos[b]``
    is row b's first write position: S == 1 is the paged decode tick,
    S > 1 the paged suffix prefill (positions ``cache_pos[b] + s``, writes
    masked by ``kv_write_mask``), which takes ``logits_at`` as prefill
    does."""
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    windows = layer_windows(cfg)
    layers = _layers(cfg, params)

    def tables(positions):                  # (B or 1, S) -> rope_tables
        if not cfg.rope_theta:
            return None
        return rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    if mode == "prefill":
        rope_cs = tables(torch.arange(S, dtype=torch.int32,
                                      device=x.device)[None, :])
        ks, vs = [], []
        for lp, w in zip(layers, windows):
            x, kv = _decoder_layer(cfg, lp, x, rope_cs=rope_cs, window=w,
                                   return_kv=True)
            ks.append(kv["k"])
            vs.append(kv["v"])
        return (_unembed(cfg, params, _pick(x, logits_at)),
                {"k": torch.stack(ks), "v": torch.stack(vs)})
    if mode != "decode":
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode')")
    if cache is None or cache_pos is None or cache_pos.ndim != 1:
        raise ValueError("decode needs a cache and (B,) cache positions")
    if S != 1 and page_table is None:
        raise ValueError("decode takes one token per row; S > 1 only on "
                         "the paged branch (suffix prefill)")
    rope_cs = tables(cache_pos.to(torch.int32)[:, None] + torch.arange(
        S, dtype=torch.int32, device=x.device)[None, :])
    for i, (lp, w) in enumerate(zip(layers, windows)):
        x, _ = _decoder_layer(
            cfg, lp, x, rope_cs=rope_cs, window=w,
            cache={"k": cache["k"][i], "v": cache["v"][i]},
            cache_pos=cache_pos, impl=attn_impl, page_table=page_table,
            kv_write_mask=kv_write_mask)
    return _unembed(cfg, params, _pick(x, logits_at)), cache


def _pick(x: torch.Tensor, logits_at: Optional[torch.Tensor]):
    """x (B, S, D), or its rows at token index ``logits_at[b]`` (B, 1, D)."""
    if logits_at is None:
        return x
    return x[torch.arange(x.shape[0], device=x.device),
             logits_at.long()][:, None]
