"""Model assembly (torch counterpart of ``repro/models/transformer.py``):
the decoder LMs (dense, moe, vlm, ssm, hybrid) and the whisper-style
encoder-decoder (encdec).

Modes:
  train   — full-sequence forward under autograd (every family), each
            layer (the encoder's too) under ``torch.utils.checkpoint``
            when ``cfg.remat`` asks for rematerialisation; returns logits
            (and the MoE aux loss) and no cache
  prefill — full-sequence forward, returns the per-layer KV cache (dense)
            or the recurrent state and ring caches (ssm, hybrid)
  decode  — one token per row against an existing cache, at per-row
            positions (the serve tick) or at one scalar position for the
            whole batch (the dry-run and test convention).  The dense KV
            cache is updated in place; the ssm and hybrid caches come back
            as new tensors and the cache passed in keeps its bits, so a
            serve engine can merge rows under a mask.  With a page table
            the dense cache is the paged pool, and S > 1 tokens per row is
            the paged suffix prefill.

The JAX package scans the stacked layers with ``jax.lax.scan``; here a
Python loop walks views of the same stacked tensors (dense, ssm) or the
unrolled ``layer_{i}`` tensors (hybrid), or the unrolled ``enc_{i}`` and
``dec_{i}`` tensors (encdec).

The residual stream passes ``constrain(x, _ACT)`` where the JAX models
call it (layer entry, after each residual add, the embedding and the
final norm, the logits): the identity unless the dry run or a launcher
has an ``activation_sharding`` active and ``x`` is a DTensor.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamDef, ParamDefs, Params,
                                       apply_rope, layer_norm, rms_norm,
                                       rope_tables, sinusoidal_positions,
                                       softcap, stacked, subtree, torch_dtype)
from repro_torch.sharding import constrain

_ACT = ("batch", "seq", "embed_act")  # canonical activation sharding


def _prefix(pre: str, defs: ParamDefs) -> ParamDefs:
    return {f"{pre}/{k}": v for k, v in defs.items()}


def _decoder_layer_defs(cfg: ModelConfig) -> ParamDefs:
    D = cfg.d_model
    defs: ParamDefs = {"ln1/g": ParamDef((D,), (None,), init="zeros")}
    if cfg.family == "ssm":
        defs.update(_prefix("ssm", ssm_mod.ssm_param_defs(cfg)))
        return defs
    defs.update(_prefix("attn", attn_mod.attn_param_defs(cfg)))
    defs["ln2/g"] = ParamDef((D,), (None,), init="zeros")
    if cfg.is_moe:
        defs.update(_prefix("moe", moe_mod.moe_param_defs(cfg)))
    else:
        defs.update(_prefix("mlp", mlp_mod.mlp_param_defs(cfg)))
    return defs


def _hybrid_layer_defs(cfg: ModelConfig, kind: str) -> ParamDefs:
    D = cfg.d_model
    defs: ParamDefs = {"ln1/g": ParamDef((D,), (None,), init="zeros"),
                       "ln2/g": ParamDef((D,), (None,), init="zeros")}
    if kind == "R":
        defs.update(_prefix("rec", rglru_mod.rglru_param_defs(cfg)))
    else:
        defs.update(_prefix("attn", attn_mod.attn_param_defs(cfg)))
    defs.update(_prefix("mlp", mlp_mod.mlp_param_defs(cfg)))
    return defs


def hybrid_pattern(cfg: ModelConfig) -> List[str]:
    """Per-layer block kind of the hybrid stack: "R" (RG-LRU) or "A"
    (local attention), the pattern string tiled over the layers."""
    pat = cfg.block_pattern or "A"
    return [pat[i % len(pat)] for i in range(cfg.num_layers)]


def _encdec_layer_defs(cfg: ModelConfig, cross: bool) -> ParamDefs:
    """One whisper layer: LayerNorms (gamma and beta), self-attention, the
    MLP and, in the decoder (``cross``), the cross-attention and its
    LayerNorm."""
    D = cfg.d_model
    defs: ParamDefs = {
        "ln1/g": ParamDef((D,), (None,), init="ones"),
        "ln1/b": ParamDef((D,), (None,), init="zeros"),
        "ln2/g": ParamDef((D,), (None,), init="ones"),
        "ln2/b": ParamDef((D,), (None,), init="zeros"),
    }
    defs.update(_prefix("attn", attn_mod.attn_param_defs(cfg)))
    defs.update(_prefix("mlp", mlp_mod.mlp_param_defs(cfg)))
    if cross:
        defs["lnx/g"] = ParamDef((D,), (None,), init="ones")
        defs["lnx/b"] = ParamDef((D,), (None,), init="zeros")
        defs.update(_prefix("xattn", attn_mod.attn_param_defs(cfg,
                                                              cross=True)))
    return defs


def model_param_defs(cfg: ModelConfig, max_seq: int) -> ParamDefs:
    """Parameter defs of the model, named as ``model.init`` names them in
    the JAX package: stacked layers under ``blocks/`` (dense, ssm), unrolled
    ``layer_{i}/`` (hybrid), unrolled ``enc_{i}/`` and ``dec_{i}/`` with the
    learned decoder positions ``pos/dec`` (max_seq, D) (encdec; no other
    family reads ``max_seq``)."""
    D, V = cfg.d_model, cfg.vocab_size
    defs: ParamDefs = {
        "emb/tok": ParamDef((V, D), ("vocab", "embed"), scale=0.02),
        "final_ln/g": ParamDef((D,), (None,), init="zeros"),
    }
    if not cfg.tie_embeddings:
        defs["emb/out"] = ParamDef((D, V), ("embed", "vocab"),
                                   scale=D ** -0.5)
    if cfg.family == "encdec":
        # whisper's LayerNorm: gamma multiplies (initialised to ones)
        for n in ("final_ln", "enc_ln"):
            defs[f"{n}/g"] = ParamDef((D,), (None,), init="ones")
            defs[f"{n}/b"] = ParamDef((D,), (None,), init="zeros")
        defs["pos/dec"] = ParamDef((max_seq, D), ("seq", "embed"),
                                   scale=0.02)
        enc = _encdec_layer_defs(cfg, cross=False)
        dec = _encdec_layer_defs(cfg, cross=True)
        for i in range(cfg.enc_layers):
            defs.update(_prefix(f"enc_{i}", enc))
        for i in range(cfg.dec_layers):
            defs.update(_prefix(f"dec_{i}", dec))
        return defs
    if cfg.family == "hybrid":
        for i, kind in enumerate(hybrid_pattern(cfg)):
            defs.update(_prefix(f"layer_{i}", _hybrid_layer_defs(cfg, kind)))
        return defs
    defs.update(stacked(_decoder_layer_defs(cfg), cfg.num_layers, "blocks"))
    return defs


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer local-attention window (0 = global)."""
    if cfg.alt_local_global:
        return [cfg.local_window if i % 2 == 0 else 0
                for i in range(cfg.num_layers)]
    return [cfg.local_window] * cfg.num_layers


def cache_param_defs(cfg: ModelConfig, batch: int, max_len: int) -> ParamDefs:
    if cfg.family == "ssm":
        return ssm_mod.ssm_state_defs(cfg, batch, cfg.num_layers)
    if cfg.family == "hybrid":
        pat = hybrid_pattern(cfg)
        n_rec = sum(1 for k in pat if k == "R")
        n_attn = len(pat) - n_rec
        W = min(cfg.local_window or max_len, max_len)
        defs = {f"rec/{k}": v for k, v in
                rglru_mod.rglru_state_defs(cfg, batch, n_rec).items()}
        K, hd = cfg.num_kv_heads, cfg.head_dim
        axes = ("stack", "batch", "kv_seq", "kv_heads", "head_dim")
        defs["attn/k"] = ParamDef((n_attn, batch, W, K, hd), axes,
                                  init="zeros")
        defs["attn/v"] = ParamDef((n_attn, batch, W, K, hd), axes,
                                  init="zeros")
        defs["attn/pos"] = ParamDef((n_attn, batch, W),
                                    ("stack", "batch", "kv_seq"),
                                    init="const", const=-1, dtype="int32")
        return defs
    if cfg.family == "encdec":
        K, hd = cfg.num_kv_heads, cfg.head_dim
        axes = ("batch", "kv_seq", "kv_heads", "head_dim")
        defs = {}
        for i in range(cfg.dec_layers):
            for n in ("k", "v"):
                defs[f"dec_{i}/{n}"] = ParamDef((batch, max_len, K, hd),
                                                axes, init="zeros")
        # the per-row encoder-output bank (kind "enc"): row b holds slot
        # b's encoder output, written at admission and read by every
        # decode tick's cross-attention
        defs["enc/out"] = ParamDef((batch, max_len, cfg.d_model),
                                   ("batch", "kv_seq", "embed"),
                                   init="zeros")
        return defs
    return attn_mod.cache_defs(cfg, batch, max_len, cfg.num_layers)


def paged_cache_param_defs(cfg: ModelConfig, num_pages: int,
                           page_size: int) -> ParamDefs:
    if cfg.family in ("ssm", "hybrid", "encdec"):
        raise ValueError(
            f"paged KV serving not supported for family '{cfg.family}' "
            "(recurrent state / ring buffers / encoder banks are not "
            "paged)")
    return attn_mod.paged_cache_defs(cfg, num_pages, page_size,
                                     cfg.num_layers)


def _layers(cfg: ModelConfig, params: Params) -> List[Params]:
    """Per-layer views of the stacked ``blocks/`` tensors (dense, ssm) or
    the ``layer_{i}/`` tensors (hybrid), grouped in one pass over the
    names."""
    if cfg.family == "hybrid":
        layers: List[Params] = [{} for _ in range(cfg.num_layers)]
        for name, w in params.items():
            if name.startswith("layer_"):
                i, rest = name[len("layer_"):].split("/", 1)
                layers[int(i)][rest] = w
        return layers
    views = {n: w.unbind(0) for n, w in subtree(params, "blocks").items()}
    return [{n: v[i] for n, v in views.items()}
            for i in range(cfg.num_layers)]


def _decoder_layer(cfg: ModelConfig, p: Params, x, *, rope_cs, window,
                   cache=None, cache_pos=None, return_kv=False, impl="plain",
                   page_table=None, kv_write_mask=None, with_aux=False):
    """Dense, moe, vlm or ssm layer body. Returns (x, new_cache, aux): aux
    is the MoE router's load-balancing loss when ``with_aux`` and the
    layer has a router, else None."""
    x = constrain(x, _ACT)
    if cfg.family == "ssm":
        h, new_state = ssm_mod.ssm_block(
            cfg, subtree(p, "ssm"), rms_norm(x, p["ln1/g"]), state=cache,
            impl=impl)
        return constrain(x + h, _ACT), new_state, None
    h, new_cache = attn_mod.attention_block(
        cfg, subtree(p, "attn"), rms_norm(x, p["ln1/g"]),
        rope_cs=rope_cs, window=window, cache=cache,
        cache_pos=cache_pos, return_kv=return_kv, impl=impl,
        page_table=page_table, kv_write_mask=kv_write_mask)
    x = constrain(x + h, _ACT)
    z = rms_norm(x, p["ln2/g"])
    if cfg.is_moe:
        m, aux = moe_mod.moe_block(cfg, subtree(p, "moe"), z,
                                   with_aux=with_aux)
    else:
        m, aux = mlp_mod.mlp_block(cfg, subtree(p, "mlp"), z), None
    return constrain(x + m, _ACT), new_cache, aux


def _embed(cfg: ModelConfig, params: Params, tokens,
           vision_embeds=None) -> torch.Tensor:
    """Token embeddings; for the vlm family, ``vision_embeds`` (B, Nv, D)
    replace each row's first Nv positions (the vision-tower stub)."""
    x = params["emb/tok"][tokens].to(torch_dtype(cfg.dtype))
    if cfg.family == "vlm" and vision_embeds is not None:
        nv = vision_embeds.shape[1]
        if nv > x.shape[1]:
            raise ValueError(f"{nv} vision embeddings for {x.shape[1]} "
                             f"positions")
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], dim=1)
    return constrain(x, _ACT)


def _unembed(cfg: ModelConfig, params: Params, x) -> torch.Tensor:
    """Final norm + output projection; returns f32 logits (after the
    optional final softcap)."""
    x = constrain(rms_norm(x, params["final_ln/g"]), _ACT)
    if cfg.tie_embeddings:
        logits = x @ params["emb/tok"].T
    else:
        logits = x @ params["emb/out"]
    logits = constrain(logits, ("batch", "seq", "vocab"))
    return softcap(logits.float(), cfg.final_softcap)


def decoder_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    mode: str = "prefill",                # train | prefill | decode
    cache: Optional[Params] = None,       # {"k","v"}: (layers,B,L,K,hd)
    cache_pos=None,                       # decode: (B,) int32 or scalar
    attn_impl: str = "plain",
    logits_at: Optional[torch.Tensor] = None,   # (B,) token indices
    page_table: Optional[torch.Tensor] = None,  # paged: (B, nb) int32
    kv_write_mask: Optional[torch.Tensor] = None,   # paged suffix: (B, S)
    vision_embeds: Optional[torch.Tensor] = None,   # vlm: (B, Nv, D)
) -> Tuple[torch.Tensor, Optional[Params], Optional[torch.Tensor]]:
    """Returns (logits, cache, aux).

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
    does.  ``attn_impl`` ("plain" | "kernel") selects the decode tick's
    attention; in train mode (logits (B, S, V) f32 and no cache), in
    prefill and in scalar-position decode (``cache_pos`` an int or a 0-d
    tensor: every row writes and attends at that position, one token a
    row, as JAX's dry-run convention; the tensor is read once a step)
    "plain" is naive attention and "kernel" ("kernel_bf16") the flash
    kernel (with bf16 probabilities), see ``attention_block``.  The ssm
    family's cache is its recurrent state (see ``_ssm_forward``); it has
    no kernel in its decode tick.  Its train mode runs each layer's
    sequence path (conv, ``ssd_chunked`` under autograd, gated RMSNorm)
    through ``_train_forward`` and returns no state.

    ``aux`` is the summed MoE load-balancing loss in train mode (moe
    family); None otherwise (the serve modes do not compute it).  The vlm
    family's ``vision_embeds`` replace the first positions of each row
    (``_embed``)."""
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens, vision_embeds)
    if cfg.family == "ssm" and mode != "train":
        return _ssm_forward(cfg, params, x, mode=mode, cache=cache,
                            cache_pos=cache_pos, logits_at=logits_at) + (
                                None,)
    windows = layer_windows(cfg)
    layers = _layers(cfg, params)

    def tables(positions):                  # (B or 1, S) -> rope_tables
        if not cfg.rope_theta or cfg.family == "ssm":
            return None
        return rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    if mode in ("train", "prefill"):
        rope_cs = tables(torch.arange(S, dtype=torch.int32,
                                      device=x.device)[None, :])
    if mode == "train":
        return _train_forward(cfg, params, x, layers, windows, rope_cs,
                              attn_impl)
    if mode == "prefill":
        ks, vs = [], []
        for lp, w in zip(layers, windows):
            x, kv, _ = _decoder_layer(cfg, lp, x, rope_cs=rope_cs, window=w,
                                      return_kv=True, impl=attn_impl)
            ks.append(kv["k"])
            vs.append(kv["v"])
        return (_unembed(cfg, params, _pick(x, logits_at)),
                {"k": torch.stack(ks), "v": torch.stack(vs)}, None)
    if mode != "decode":
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', "
                         f"'decode')")
    if cache is None or cache_pos is None:
        raise ValueError("decode needs a cache and cache positions")
    if S != 1 and page_table is None:
        raise ValueError("decode takes one token per row; S > 1 only on "
                         "the paged branch (suffix prefill)")
    if attn_mod.per_row_positions(cache_pos):
        if cache_pos.ndim != 1:
            raise ValueError("decode positions must be (B,) or a scalar")
        rope_cs = tables(cache_pos.to(torch.int32)[:, None] + torch.arange(
            S, dtype=torch.int32, device=x.device)[None, :])
    else:
        if page_table is not None:
            raise ValueError("paged decode needs (B,) first write positions")
        cache_pos = int(cache_pos)          # one host read a step
        rope_cs = tables(torch.full((1, 1), cache_pos, dtype=torch.int32,
                                    device=x.device))
    for i, (lp, w) in enumerate(zip(layers, windows)):
        x, _, _ = _decoder_layer(
            cfg, lp, x, rope_cs=rope_cs, window=w,
            cache={"k": cache["k"][i], "v": cache["v"][i]},
            cache_pos=cache_pos, impl=attn_impl, page_table=page_table,
            kv_write_mask=kv_write_mask)
    return _unembed(cfg, params, _pick(x, logits_at)), cache, None


def _train_forward(cfg: ModelConfig, params: Params, x, layers, windows,
                   rope_cs, attn_impl: str):
    """The decoder stack in train mode (dense, moe, vlm and ssm layers):
    ((B, S, V) f32 logits under autograd, no cache, the summed MoE aux
    loss or None).  Each layer runs under ``_remat``."""
    def layer(xc, lp, w):
        y, _, aux = _decoder_layer(cfg, lp, xc, rope_cs=rope_cs, window=w,
                                   impl=attn_impl, with_aux=cfg.is_moe)
        return y, aux

    aux_total = None
    for lp, w in zip(layers, windows):
        x, aux = _remat(cfg, layer, x, lp, w)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return _unembed(cfg, params, x), None, aux_total


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, rematerialised as ``_maybe_remat`` asks: with
    ``cfg.remat`` other than "none" under ``torch.utils.checkpoint``
    (non-reentrant), which keeps only the layer's inputs and runs the
    layer forward again in the backward.  "dots" (JAX's
    ``checkpoint_dots`` policy, which also keeps the matmul outputs) has
    no torch policy here and is treated as "full".  The model draws no
    random numbers, so the RNG state is not stashed for the recompute."""
    if cfg.remat == "none":
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _pick(x: torch.Tensor, logits_at: Optional[torch.Tensor]):
    """x (B, S, D), or its rows at token index ``logits_at[b]`` (B, 1, D)."""
    if logits_at is None:
        return x
    return x[torch.arange(x.shape[0], device=x.device),
             logits_at.long()][:, None]


def _check_decode(mode: str, cache, cache_pos, S: int) -> None:
    """The recurrent families decode one token per row at (B,) positions
    or at one scalar position."""
    if mode != "decode":
        raise ValueError(f"mode {mode!r} not in ('prefill', 'decode')")
    if cache is None or cache_pos is None or (
            attn_mod.per_row_positions(cache_pos) and cache_pos.ndim != 1):
        raise ValueError("decode needs a cache and (B,) or scalar cache "
                         "positions")
    if S != 1:
        raise ValueError(f"decode takes one token per row, got S = {S}")


def _ssm_forward(cfg: ModelConfig, params: Params, x, *, mode, cache,
                 cache_pos, logits_at):
    """The mamba2 stack.  Prefill runs the causal conv and the chunked SSD
    scan (``ops.ssd_scan``) of every layer and returns the
    state ``{"conv": (layers,B,W-1,d_xbc), "ssm": (layers,B,H,P,N) f32}``;
    decode runs every layer's O(1) recurrent update and returns the
    advanced state as new tensors (``cache_pos``, a (B,) vector or a
    scalar, is not read: the state is positionless)."""
    layers = _layers(cfg, params)
    if mode == "prefill":
        convs, ssms = [], []
        for lp in layers:
            x, st, _ = _decoder_layer(cfg, lp, x, rope_cs=None, window=0,
                                      impl="kernel")
            convs.append(st["conv"])
            ssms.append(st["ssm"])
        return (_unembed(cfg, params, _pick(x, logits_at)),
                {"conv": torch.stack(convs), "ssm": torch.stack(ssms)})
    _check_decode(mode, cache, cache_pos, x.shape[1])
    new = {n: torch.empty_like(c) for n, c in cache.items()}
    for i, lp in enumerate(layers):
        x, st, _ = _decoder_layer(
            cfg, lp, x, rope_cs=None, window=0,
            cache={"conv": cache["conv"][i], "ssm": cache["ssm"][i]})
        new["conv"][i] = st["conv"]
        new["ssm"][i] = st["ssm"]
    return _unembed(cfg, params, _pick(x, logits_at)), new


def _ring_decode_layer(cfg: ModelConfig, p: Params, z, k_l, v_l, pos_l,
                       cache_pos, rope_cs):
    """Local attention of one decode tick against a ring-buffer cache of
    size Wr: row b writes its k/v into its own slot ``cache_pos[b] % Wr``
    of COPIES of the ring (the cache passed in keeps its bits) and attends
    through ``ring_decode_attention``'s per-row position mask.  At a
    scalar position (an int) every row writes slot ``cache_pos % Wr`` and
    attends through ``naive_attention`` at ``q_offset = cache_pos`` over
    row 0's slot positions, as JAX's scalar ring decode.  Returns (y, (k,
    v, pos) rings)."""
    B, S, D = z.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (z @ p["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = (z @ p["wk"].reshape(D, K * hd)).reshape(B, S, K, hd)
    v = (z @ p["wv"].reshape(D, K * hd)).reshape(B, S, K, hd)
    if rope_cs is not None:
        q = apply_rope(q, *rope_cs)
        k = apply_rope(k, *rope_cs)
    k_l, v_l, pos_l = k_l.clone(), v_l.clone(), pos_l.clone()
    if not attn_mod.per_row_positions(cache_pos):
        slot = cache_pos % k_l.shape[1]
        k_l[:, slot] = k[:, 0].to(k_l.dtype)
        v_l[:, slot] = v[:, 0].to(v_l.dtype)
        pos_l[:, slot] = cache_pos
        out = attn_mod.naive_attention(
            q, k_l, v_l, causal=True, window=cfg.local_window,
            logit_cap=cfg.attn_softcap, q_offset=cache_pos,
            k_positions=pos_l[0])
    else:
        rows = torch.arange(B, device=z.device)
        slot = cache_pos.long() % k_l.shape[1]
        k_l[rows, slot] = k[:, 0].to(k_l.dtype)
        v_l[rows, slot] = v[:, 0].to(v_l.dtype)
        pos_l[rows, slot] = cache_pos.to(pos_l.dtype)
        out = attn_mod.ring_decode_attention(
            q, k_l, v_l, q_pos=cache_pos, k_positions=pos_l,
            window=cfg.local_window, logit_cap=cfg.attn_softcap)
    y = out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return y, (k_l, v_l, pos_l)


def _ring_fold(k, v, W: int):
    """The last W prefill keys in the ring layout: slot = pos % W; empty
    slots (pos -1) take the unused tail slots so they never clobber a real
    key.  k/v (B,S,K,hd) -> rings (B,W,K,hd) and positions (B,W) int32."""
    B, S = k.shape[:2]
    n = min(W, S)
    dev = k.device
    ks, vs = k[:, S - n:], v[:, S - n:]
    kpos = torch.arange(S - n, S, device=dev)
    if W > n:
        pad = torch.zeros((B, W - n) + tuple(k.shape[2:]), dtype=k.dtype,
                          device=dev)
        ks, vs = torch.cat([ks, pad], 1), torch.cat([vs, pad], 1)
        kpos = torch.cat([kpos, torch.full((W - n,), -1, device=dev)])
    slots = torch.where(kpos >= 0, kpos % W, torch.arange(W, device=dev))
    k_r, v_r = torch.zeros_like(ks), torch.zeros_like(vs)
    k_r[:, slots] = ks
    v_r[:, slots] = vs
    p_r = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    p_r[:, slots] = kpos.to(torch.int32)
    return k_r, v_r, p_r


def hybrid_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    mode: str = "prefill",                # train | prefill | decode
    cache: Optional[Params] = None,
    cache_pos=None,                       # decode: (B,) int32 or scalar
    attn_impl: str = "plain",
    logits_at: Optional[torch.Tensor] = None,   # (B,) token indices
) -> Tuple[torch.Tensor, Optional[Params]]:
    """The recurrentgemma stack (unrolled ``layer_{i}``, pattern of "R"
    RG-LRU and "A" local-attention blocks).  Returns (logits, cache).

    Train: (B, S, V) f32 logits under autograd and no cache; each layer
    (``_hybrid_train_layer``) under ``_remat``, as JAX's ``_train_layer``
    under ``_maybe_remat``.  ``attn_impl="kernel"`` runs R layers through
    ``ops.RGLRUGatedScan`` and A layers through the flash kernel
    (``FlashAttention``, window ``local_window``); ``"plain"`` through
    the plain scan and naive attention under autograd.

    Prefill: every R layer's recurrence runs through the kernel scan
    (``ops.rglru_scan``, as the ssm prefill's SSD scan), every A layer's
    windowed prefill attention through ``attention_block`` by
    ``attn_impl`` ("plain" naive, "kernel" / "kernel_bf16" the flash
    kernel); the cache holds each R layer's final ``rec/h`` and
    ``rec/conv`` and each A layer's last W = ``local_window`` keys folded
    into the ring layout.  Decode (per-row ``cache_pos`` (B,), or one
    scalar position for every row): each R layer's recurrent step (the
    scan at S = 1, by ``attn_impl``) and each A layer's ring write and
    attention (``_ring_decode_layer``); the advanced cache comes back as
    new tensors."""
    S = tokens.shape[1]
    x = _embed(cfg, params, tokens)
    decode = mode == "decode"
    if decode:
        _check_decode(mode, cache, cache_pos, S)
        if attn_mod.per_row_positions(cache_pos):
            positions = cache_pos.to(torch.int32)[:, None]
        else:
            cache_pos = int(cache_pos)          # one host read a step
            positions = torch.full((1, 1), cache_pos, dtype=torch.int32,
                                   device=x.device)
    elif mode in ("train", "prefill"):
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None]
    else:
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', "
                         f"'decode')")
    rope_cs = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
               if cfg.rope_theta else None)
    if mode == "train":
        for lp, kind in zip(_layers(cfg, params), hybrid_pattern(cfg)):
            x = _remat(cfg, _hybrid_train_layer, cfg, lp, x, kind, rope_cs,
                       attn_impl)
        return _unembed(cfg, params, x), None
    W = cfg.local_window
    new = {n: [] for n in ("rec/h", "rec/conv", "attn/k", "attn/v",
                           "attn/pos")}
    for lp, kind in zip(_layers(cfg, params), hybrid_pattern(cfg)):
        z = rms_norm(x, lp["ln1/g"])
        if kind == "R":
            r_i = len(new["rec/h"])
            st = ({"h": cache["rec/h"][r_i], "conv": cache["rec/conv"][r_i]}
                  if decode else None)
            h, st = rglru_mod.rglru_block(
                cfg, subtree(lp, "rec"), z, state=st,
                impl=attn_impl if decode else "kernel")
            new["rec/h"].append(st["h"])
            new["rec/conv"].append(st["conv"])
        else:
            if decode:
                a_i = len(new["attn/k"])
                h, rings = _ring_decode_layer(
                    cfg, subtree(lp, "attn"), z, cache["attn/k"][a_i],
                    cache["attn/v"][a_i], cache["attn/pos"][a_i], cache_pos,
                    rope_cs)
            else:
                h, kv = attn_mod.attention_block(
                    cfg, subtree(lp, "attn"), z, rope_cs=rope_cs, window=W,
                    return_kv=True, impl=attn_impl)
                rings = _ring_fold(kv["k"], kv["v"], W)
            for n, t in zip(("attn/k", "attn/v", "attn/pos"), rings):
                new[n].append(t)
        x = constrain(x + h, _ACT)
        x = constrain(x + mlp_mod.mlp_block(cfg, subtree(lp, "mlp"),
                                            rms_norm(x, lp["ln2/g"])), _ACT)
    return (_unembed(cfg, params, _pick(x, logits_at)),
            {n: torch.stack(ts) for n, ts in new.items() if ts})


def _hybrid_train_layer(cfg: ModelConfig, lp: Params, x, kind: str, rope_cs,
                        attn_impl: str):
    """One hybrid layer in train mode: no state in, none out."""
    z = rms_norm(x, lp["ln1/g"])
    if kind == "R":
        h, _ = rglru_mod.rglru_block(cfg, subtree(lp, "rec"), z,
                                     impl=attn_impl)
    else:
        h, _ = attn_mod.attention_block(cfg, subtree(lp, "attn"), z,
                                        rope_cs=rope_cs,
                                        window=cfg.local_window,
                                        impl=attn_impl)
    x = constrain(x + h, _ACT)
    return constrain(x + mlp_mod.mlp_block(cfg, subtree(lp, "mlp"),
                                           rms_norm(x, lp["ln2/g"])), _ACT)


# ---------------------------------------------------------------------------
# encoder-decoder (whisper)
# ---------------------------------------------------------------------------


def _encdec_layer(cfg: ModelConfig, p: Params, x, *, causal: bool,
                  impl: str, enc_out=None, cache=None, cache_pos=None,
                  return_kv: bool = False):
    """One pre-LayerNorm whisper layer: self-attention (no RoPE; causal in
    the decoder, over ``cache`` in decode), cross-attention over
    ``enc_out`` when given (the decoder), the MLP.  Returns (x, kv)."""
    h, kv = attn_mod.attention_block(
        cfg, subtree(p, "attn"), layer_norm(x, p["ln1/g"], p["ln1/b"]),
        rope_cs=None, causal=causal, window=0, cache=cache,
        cache_pos=cache_pos, return_kv=return_kv, impl=impl)
    x = constrain(x + h, _ACT)
    if enc_out is not None:
        h, _ = attn_mod.attention_block(
            cfg, subtree(p, "xattn"), layer_norm(x, p["lnx/g"], p["lnx/b"]),
            rope_cs=None, kv_source=enc_out, impl=impl)
        x = constrain(x + h, _ACT)
    return constrain(x + mlp_mod.mlp_block(
        cfg, subtree(p, "mlp"), layer_norm(x, p["ln2/g"], p["ln2/b"])),
        _ACT), kv


def _encdec_train_layer(cfg: ModelConfig, p: Params, x, enc_out,
                        causal: bool, impl: str):
    """``_encdec_layer`` in train mode: no cache, no K/V out; ``enc_out``
    is an argument, so that under ``_remat`` its gradient flows back to
    the encoder."""
    return _encdec_layer(cfg, p, x, causal=causal, impl=impl,
                         enc_out=enc_out)[0]


def encoder_forward(cfg: ModelConfig, params: Params, frames: torch.Tensor,
                    attn_impl: str = "kernel",
                    train: bool = False) -> torch.Tensor:
    """The whisper encoder over frames (B, Se, D) (the conv frontend is a
    stub: the frames are given), with sinusoidal positions and
    bidirectional self-attention by ``attn_impl`` (``ATTN_IMPLS``: "kernel"
    the flash kernel, non-causal, as JAX's "chunked" default); returns the
    final-LayerNormed (B, Se, D) output in the model dtype.  With
    ``train`` each layer runs under ``_remat``, as JAX's under
    ``_maybe_remat(..., "train")``."""
    B, Se, D = frames.shape
    dt = torch_dtype(cfg.dtype)
    x = constrain(frames.to(dt) + sinusoidal_positions(
        Se, D, frames.device).to(dt)[None], _ACT)
    for i in range(cfg.enc_layers):
        lp = subtree(params, f"enc_{i}")
        if train:
            x = _remat(cfg, _encdec_train_layer, cfg, lp, x, None, False,
                       attn_impl)
        else:
            x, _ = _encdec_layer(cfg, lp, x, causal=False, impl=attn_impl)
    return layer_norm(x, params["enc_ln/g"], params["enc_ln/b"])


def encdec_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                 # (B, S) int
    *,
    frames: Optional[torch.Tensor] = None,    # (B, Se, D)
    enc_out: Optional[torch.Tensor] = None,   # (B, Se, D)
    mode: str = "prefill",                # train | prefill | decode
    cache: Optional[Params] = None,       # dec_{i}/k|v, enc/out
    cache_pos=None,                       # decode: (B,) int32 or scalar
    attn_impl: str = "plain",
    logits_at: Optional[torch.Tensor] = None,   # (B,) token indices
) -> Tuple[torch.Tensor, Optional[Params]]:
    """The whisper decoder, after the encoder when ``frames`` are given.
    Returns (f32 logits, cache).

    The cross-attention source is ``enc_out``, else the encoder's output
    over ``frames`` (by ``attn_impl``), else the cache's per-row
    ``enc/out`` bank: in the serve tick each slot decodes against its own
    encoder output.  Its K/V are projected from the source on every call.

    Train: as prefill under autograd, with no cache in or out: learned
    positions ``pos/dec[:S]``, causal self-attention, the cross-attention
    over the source, each layer (the encoder's too, when it runs on
    ``frames``) under ``_remat`` with the source passed in; (B, S, V)
    logits.  With no source the layers have no cross-attention, as JAX's
    ``_encdec_layer`` skips it for ``enc_out=None``: the JAX launcher
    trains whisper on tokens alone.

    Prefill: learned positions ``pos/dec[:S]``, causal self-attention and
    non-causal cross-attention by ``attn_impl`` (``ATTN_IMPLS``); returns
    (B, S, V) logits, or (B, 1, V) at ``logits_at[b]``, and the fresh
    ``dec_{i}/k|v`` (B, S, K, hd).  Decode: one token a row at per-row
    positions ``cache_pos`` (B,) (row b takes ``pos/dec[cache_pos[b]]`` and
    writes its K/V at its own position, ``attn_impl`` in ``DECODE_IMPLS``)
    or at one scalar position (the dry-run convention, read once a step);
    the cache is updated in place and returned, ``enc/out`` unchanged.
    The cross-attention takes ``attn_impl`` in every mode ("kernel": the
    flash kernel, non-causal, Sq 1 in decode); the logits come from
    ``_encdec_unembed``."""
    train = mode == "train"
    if enc_out is None and frames is not None:
        enc_out = encoder_forward(cfg, params, frames, attn_impl,
                                  train=train)
    if enc_out is None and cache is not None and "enc/out" in cache:
        enc_out = cache["enc/out"]
    if enc_out is None and not train:
        raise ValueError("encdec needs frames, enc_out or a cache holding "
                         "enc/out")
    S = tokens.shape[1]
    pos_dec = params["pos/dec"]
    if mode in ("train", "prefill"):
        pos_emb = pos_dec[:S][None]
    elif mode == "decode":
        _check_decode(mode, cache, cache_pos, S)
        if attn_mod.per_row_positions(cache_pos):
            pos_emb = pos_dec[cache_pos.long()][:, None]
        else:
            cache_pos = int(cache_pos)          # one host read a step
            pos_emb = pos_dec[cache_pos:cache_pos + 1][None]
    else:
        raise ValueError(f"mode {mode!r} not in ('train', 'prefill', "
                         f"'decode')")
    x = constrain(params["emb/tok"][tokens].to(torch_dtype(cfg.dtype))
                  + pos_emb, _ACT)
    if train:
        for i in range(cfg.dec_layers):
            x = _remat(cfg, _encdec_train_layer, cfg,
                       subtree(params, f"dec_{i}"), x, enc_out, True,
                       attn_impl)
        return _encdec_unembed(cfg, params, x), None
    fresh: Params = {}
    for i in range(cfg.dec_layers):
        c_i = (None if mode == "prefill" else
               {"k": cache[f"dec_{i}/k"], "v": cache[f"dec_{i}/v"]})
        x, kv = _encdec_layer(
            cfg, subtree(params, f"dec_{i}"), x, causal=True, impl=attn_impl,
            enc_out=enc_out, cache=c_i, cache_pos=cache_pos,
            return_kv=mode == "prefill")
        if mode == "prefill":
            fresh[f"dec_{i}/k"], fresh[f"dec_{i}/v"] = kv["k"], kv["v"]
    return (_encdec_unembed(cfg, params, _pick(x, logits_at)),
            fresh if mode == "prefill" else cache)


def _encdec_unembed(cfg: ModelConfig, params: Params, x) -> torch.Tensor:
    """The final LayerNorm, then the unembedding (through the tied
    embedding) in the model dtype, then the f32 cast, as JAX's."""
    x = layer_norm(x, params["final_ln/g"], params["final_ln/b"])
    if cfg.tie_embeddings:
        logits = x @ params["emb/tok"].T
    else:
        logits = x @ params["emb/out"]
    return logits.float()
