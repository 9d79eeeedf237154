"""GQA attention (torch counterpart of the decoder parts of
``repro/models/attention.py``): projections, RoPE, the O(S^2) attention
(``naive_attention``), the flash attention with its blockwise backward
(``FlashAttention``, ``chunked_attention``) that train, prefill and
scalar-position decode run through, the per-row-position decode tick, its
paged branch (KV in a shared physical page pool addressed through page
tables), the paged suffix prefill, the hybrid family's ring-buffer decode
attention and the KV cache definitions.  Both take a query offset, a
valid-key length and explicit key positions as JAX's do, non-causal
masks and a cross-attention source (``kv_source``).

The decode tick has two implementations selected by ``impl``:
``"plain"`` scatters the new K/V row into the cache and runs the plain
decode attention (the parity oracle); ``"kernel"`` calls
``kernels.ops.decode_attention_fused`` (``paged_decode_attention_fused``
on the paged branch), which writes the row and attends in one CUDA launch
(and takes the same plain version on CPU tensors).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.decode_attention import (NEG_INF,
                                                  decode_attention_plain)
from repro_torch.kernels.paged_attention import gather_pages, write_rows
from repro_torch.models.common import (ParamDef, ParamDefs, Params,
                                       apply_rope, softcap)

DECODE_IMPLS = ("plain", "kernel")
# train, prefill and scalar-position decode: naive (JAX "naive"), the flash
# kernel (JAX "chunked"), the flash kernel with bf16 P (JAX "chunked_bf16")
ATTN_IMPLS = ("plain", "kernel", "kernel_bf16")


def attn_param_defs(cfg: ModelConfig, cross: bool = False) -> ParamDefs:
    """The projections of one attention op; a cross-attention op
    (``cross``, k and v projected from the encoder output) has the same
    names and shapes."""
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    defs: ParamDefs = {
        "wq": ParamDef((D, H, hd), ("qkv_in", "heads", "head_dim")),
        "wk": ParamDef((D, K, hd), ("qkv_in", "kv_heads", "head_dim")),
        "wv": ParamDef((D, K, hd), ("qkv_in", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, D), ("heads", "head_dim", "qkv_in")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((K, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((K, hd), ("kv_heads", "head_dim"), init="zeros")
    return defs


def _mask_bias(q_pos, k_pos, *, window: int, causal: bool = True,
               kv_len=None) -> torch.Tensor:
    """Additive mask bias (0 or NEG_INF). q_pos (Sq,), k_pos (Skv,);
    ``window`` <= 0 means global; keys at or past ``kv_len`` (None: none)
    and keys at negative positions (empty ring slots) are masked."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    if kv_len is not None:
        ok &= k_pos[None, :] < kv_len
    ok &= k_pos[None, :] >= 0
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def naive_attention(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                    q_offset=0, kv_len=None, k_positions=None) -> torch.Tensor:
    """O(S^2)-memory attention (the oracle, and the hybrid family's
    scalar ring decode, whose key slots carry explicit positions). q
    (B,Sq,H,hd); k/v (B,Skv,K,hd); query row i at ``q_offset + i``; key t
    at ``k_positions[t]`` (default t), dead at or past ``kv_len`` or below
    0.  ``q_offset`` and ``kv_len`` may be ints or 0-d tensors.  Its
    products go to ``torch.einsum``, as the JAX package leaves them to
    XLA."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, Sq, K, G, hd).float() * hd ** -0.5
    logits = torch.einsum("bskgh,btkh->bskgt", qr, k.float())
    logits = softcap(logits, logit_cap)
    k_pos = (torch.arange(Skv, device=q.device) if k_positions is None
             else k_positions.to(q.device))
    bias = _mask_bias(q_offset + torch.arange(Sq, device=q.device), k_pos,
                      window=window, causal=causal, kv_len=kv_len)
    logits = logits + bias[None, :, None, None, :]
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bskgt,btkh->bskgh", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Flash attention with a flash-style backward: the torch counterpart
    of ``flash_attention_jnp`` and its custom VJP.

    Forward: ``ops.flash_attention`` on transposed views of the model's
    (B, S, H, hd) tensors (no copy): the CUDA kernel on the card, its plain
    version on the CPU, with the query offset, the valid-key length and
    ``p_bf16`` passed through (host ints).  It saves (q, k, v, o, lse).
    The saved o is the output in its own dtype: JAX takes ``delta = sum(do
    * out)`` from the f32 accumulator, which for f32 inputs is the same
    tensor; for bf16 the difference is o's bf16 rounding (relative 2^-9),
    below the rounding of the bf16 gradients the backward returns.

    Backward: ``_flash_bwd_rule`` in plain PyTorch on both devices,
    streaming ``kv_block`` keys at a time, recomputing the probabilities
    from lse and accumulating dq, dk, dv in f32 with the softcap
    derivative; the same mask (query offset, valid-key length) makes a dead
    key's p exactly 0, so its dk and dv rows are 0.  Under ``p_bf16`` p is
    rounded to bf16 before it meets dp and do, as JAX's
    ``_flash_bwd_rule``.  The last block may be short; JAX pads it with
    masked keys that contribute nothing."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, logit_cap: float,
                kv_block: int, q_offset: int, kv_len: Optional[int],
                p_bf16: bool):
        o, lse = kernel_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, logit_cap=logit_cap,
            q_offset=q_offset, kv_len=kv_len, p_bf16=p_bf16,
            return_lse=True)
        o = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, window, logit_cap, kv_block, q_offset, kv_len,
                   p_bf16)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, logit_cap, kv_block, q_offset, kv_len, p_bf16 = \
            ctx.cfg
        B, Sq, H, hd = q.shape
        Skv, K = k.shape[1], k.shape[2]
        G = H // K
        scale = hd ** -0.5
        qr = q.reshape(B, Sq, K, G, hd).float()
        dor = do.reshape(B, Sq, K, G, hd).float()
        delta = torch.sum(dor * o.reshape(B, Sq, K, G, hd).float(), dim=-1)
        lse = lse.transpose(1, 2).reshape(B, Sq, K, G)
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        dq = torch.zeros((B, Sq, K, G, hd), dtype=torch.float32,
                         device=q.device)
        dk = torch.empty((B, Skv, K, hd), dtype=torch.float32,
                         device=q.device)
        dv = torch.empty_like(dk)
        for j0 in range(0, Skv, kv_block):
            j1 = min(j0 + kv_block, Skv)
            kj, vj = k[:, j0:j1].float(), v[:, j0:j1].float()
            s_raw = torch.einsum("bskgh,btkh->bskgt", qr * scale, kj)
            s = softcap(s_raw, logit_cap)
            bias = _mask_bias(q_pos, torch.arange(j0, j1, device=q.device),
                              window=window, causal=causal, kv_len=kv_len)
            p = torch.exp(s + bias[None, :, None, None, :] - lse[..., None])
            if p_bf16:
                p = p.to(torch.bfloat16).float()
            dp = torch.einsum("bskgh,btkh->bskgt", dor, vj)
            ds = p * (dp - delta[..., None])
            if logit_cap:
                t = torch.tanh(s_raw / logit_cap)  # d softcap = 1 - tanh^2
                ds = ds * (1.0 - t * t)
            dq += torch.einsum("bskgt,btkh->bskgh", ds, kj) * scale
            dk[:, j0:j1] = torch.einsum("bskgt,bskgh->btkh", ds, qr) * scale
            dv[:, j0:j1] = torch.einsum("bskgt,bskgh->btkh", p, dor)
        return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype)) + (None,) * 7


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      logit_cap: float = 0.0, q_offset: int = 0,
                      kv_len: Optional[int] = None, kv_block: int = 512,
                      p_bf16: bool = False) -> torch.Tensor:
    """Flash attention in the model layout, q (B,S,H,hd), k/v
    (B,Skv,K,hd) -> (B,S,H,hd), differentiable (see ``FlashAttention``);
    ``window`` <= 0 is global; query row i at position ``q_offset + i``,
    keys at or past ``kv_len`` (None: Skv) dead, both host ints (the
    kernel's arguments: read a 0-d tensor once with ``int()``);
    ``p_bf16`` rounds the probabilities to bf16 before P.V."""
    return FlashAttention.apply(q, k, v, causal, window, logit_cap,
                                kv_block, q_offset, kv_len, p_bf16)


def decode_attention(q, k, v, *, pos, window=0, logit_cap=0.0):
    """Single-new-token attention with PER-ROW cache positions (serving).

    q: (B, 1, H, hd); k/v: (B, L, K, hd) full cache buffers; pos: (B,)
    int — row b attends key indices <= pos[b] (and inside its local window
    when ``window`` > 0).  Rows are independent: stale KV of freed slots
    or not-yet-written positions cannot leak into a live sequence."""
    return decode_attention_plain(q[:, 0], k, v, pos, window,
                                  logit_cap=logit_cap)[:, None]


def ring_decode_attention(q, k, v, *, q_pos, k_positions, window=0,
                          logit_cap=0.0) -> torch.Tensor:
    """Single-new-token attention over PER-ROW ring-buffer caches (the
    hybrid family's serve decode tick; plain torch, as the JAX package's
    is plain jnp).

    q (B, 1, H, hd); k/v (B, W, K, hd) ring buffers; q_pos (B,) per-row
    query positions; k_positions (B, W) per-row slot positions (-1 =
    empty).  Row b attends slots with ``0 <= k_positions[b, t] <=
    q_pos[b]`` inside its local window, so a freshly reset ring
    contributes nothing and rows stay independent."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qr = q.reshape(B, K, G, hd).float() * hd ** -0.5
    logits = softcap(torch.einsum("bkgh,btkh->bkgt", qr, k.float()),
                     logit_cap)
    kp = k_positions.to(torch.int32)
    qp = q_pos.to(torch.int32)[:, None]
    ok = (kp <= qp) & (kp >= 0)
    if window > 0:
        ok &= kp > qp - window
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    logits = logits + torch.where(ok, zero, torch.full_like(zero, NEG_INF)
                                  )[:, None, None, :]
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def paged_suffix_attention(q, k, v, *, q_pos, window=0,
                           logit_cap=0.0) -> torch.Tensor:
    """Suffix-prefill attention over a row-linearized paged cache.

    q (B,S,H,hd) suffix queries; k/v (B,L,K,hd) caches gathered through
    each row's page table that already hold the suffix rows at their
    positions; q_pos (B,S) global query positions, row-varying because
    each suffix starts at that row's shared-prefix length.  Query (b, s)
    attends ``k_idx <= q_pos[b, s]`` inside its window, which is both the
    causal mask within the suffix and the guard that hides TRASH-page rows
    past the row's own depth.  Forms (B, S, K, G, L) f32 logits: transient,
    freed when the call returns."""
    B, S, H, hd = q.shape
    L, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, S, K, G, hd).float() * hd ** -0.5
    logits = softcap(torch.einsum("bskgh,btkh->bskgt", qr, k.float()),
                     logit_cap)
    k_idx = torch.arange(L, device=q.device)
    qp = q_pos.long()[:, :, None]
    ok = k_idx[None, None, :] <= qp
    if window > 0:
        ok &= k_idx[None, None, :] > qp - window
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    logits = logits + torch.where(ok, zero, torch.full_like(zero, NEG_INF)
                                  )[:, :, None, None, :]
    p = torch.softmax(logits, dim=-1)
    del logits
    out = torch.einsum("bskgt,btkh->bskgh", p, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def _paged_attention(cfg: ModelConfig, q, k, v, cache, cache_pos,
                     page_table, kv_write_mask, window, impl):
    """The paged branch of ``attention_block``: KV lives in a shared
    physical pool (P, ps, K, hd) per layer and row b's logical page i maps
    to ``page_table[b, i]``.  The last pool page is TRASH: masked and
    out-of-range writes land there (finite values, so masked softmax terms
    stay exact zeros) and the per-row mask keeps it unreadable.  The pools
    are updated in place."""
    S = q.shape[1]
    ck, cv = cache["k"], cache["v"]
    if impl == "kernel" and S == 1:
        return kernel_ops.paged_decode_attention_fused(
            q[:, 0], ck, cv, k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype),
            page_table, cache_pos, window,
            logit_cap=cfg.attn_softcap)[:, None]
    if impl == "kernel":
        raise ValueError("impl='kernel' is the single-token paged decode "
                         "kernel; the suffix prefill takes impl='plain'")
    if impl != "plain":
        raise ValueError(f"decode impl {impl!r} not in {DECODE_IMPLS}")
    # scatter this step's S rows through the page table (cache_pos[b] is
    # row b's FIRST write position), then gather each row's pages into a
    # linear (B, nb*ps) cache and attend with per-row positions
    trash = ck.shape[0] - 1
    wp = write_rows(ck, k, page_table, cache_pos, kv_write_mask, trash=trash)
    write_rows(cv, v, page_table, cache_pos, kv_write_mask, trash=trash)
    lin_k, lin_v = gather_pages(ck, page_table), gather_pages(cv, page_table)
    if S == 1:
        return decode_attention(q, lin_k, lin_v, pos=cache_pos,
                                window=window, logit_cap=cfg.attn_softcap)
    return paged_suffix_attention(q, lin_k, lin_v, q_pos=wp, window=window,
                                  logit_cap=cfg.attn_softcap)


def per_row_positions(cache_pos) -> bool:
    """Per-row decode positions (a (B,) tensor), not one scalar position
    (an int or a 0-d tensor)."""
    return isinstance(cache_pos, torch.Tensor) and cache_pos.ndim >= 1


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool, window: int,
            impl: str, q_offset=0, kv_len=None) -> torch.Tensor:
    """Train, prefill and scalar-decode attention by ``impl``: "plain" is
    ``naive_attention``, "kernel" ``chunked_attention`` (the flash
    kernel), "kernel_bf16" the same with ``p_bf16``."""
    if impl == "plain":
        return naive_attention(q, k, v, causal=causal, window=window,
                               logit_cap=cfg.attn_softcap,
                               q_offset=q_offset, kv_len=kv_len)
    if impl in ("kernel", "kernel_bf16"):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 logit_cap=cfg.attn_softcap,
                                 q_offset=q_offset, kv_len=kv_len,
                                 p_bf16=impl == "kernel_bf16")
    raise ValueError(f"attention impl {impl!r} not in {ATTN_IMPLS}")


def attention_block(
    cfg: ModelConfig,
    p: Params,
    x: torch.Tensor,                    # (B, S, D)
    *,
    rope_cs: Optional[Tuple[torch.Tensor, torch.Tensor]],  # rope_tables
    causal: bool = True,
    window: int = 0,
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k","v"}: (B,L,K,hd)
    cache_pos=None,                     # decode: (B,) int, or a scalar
    kv_source: Optional[torch.Tensor] = None,   # cross source (B, Skv, D)
    return_kv: bool = False,
    impl: str = "plain",
    page_table: Optional[torch.Tensor] = None,     # paged: (B, nb) int32
    kv_write_mask: Optional[torch.Tensor] = None,  # paged suffix: (B, S)
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention op incl. projections, RoPE (``rope_cs`` = the
    positions' ``rope_tables``, None without RoPE) and cache handling.

    With ``kv_source`` k and v are projected from it (cross-attention), no
    RoPE touches q or k, and the mask is not causal; ``causal=False``
    alone drops the causal mask too.

    Prefill (``cache is None``, ``return_kv``) and train (``cache is
    None``): attention over the sequence by ``impl`` (``ATTN_IMPLS``:
    "plain" = ``naive_attention``, as JAX's "naive"; "kernel" =
    ``chunked_attention``, the flash kernel forward and its blockwise
    backward, as JAX's "chunked"; "kernel_bf16" with ``p_bf16``, as
    "chunked_bf16"); prefill returns the computed k/v as the cache.

    Scalar decode (``cache_pos`` an int or a 0-d tensor, S == 1, a dense
    cache): the step's k/v is written at ``cache_pos`` for every row, IN
    PLACE in ``cache``, and attended by ``impl`` with ``q_offset =
    cache_pos`` and ``kv_len = cache_pos + 1``; a 0-d tensor is read once
    here (``decoder_forward`` reads it once a step and passes an int).

    Vector decode (``cache_pos`` a (B,) vector, S == 1): row b writes its
    k/v at its own position ``cache_pos[b]`` — IN PLACE in ``cache`` (the
    JAX package returned new buffers) — and attends its own prefix,
    ``impl`` in ``DECODE_IMPLS``.  With ``page_table`` the cache is the
    paged pool and ``cache_pos[b]`` is row b's first write position: S ==
    1 is the paged decode tick, S > 1 the paged suffix prefill (positions
    ``cache_pos[b] + s``, writes masked by ``kv_write_mask``)."""
    B, S, D = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    src = x if kv_source is None else kv_source
    Skv = src.shape[1]
    q = (x @ p["wq"].reshape(D, H * hd)).reshape(B, S, H, hd)
    k = (src @ p["wk"].reshape(D, K * hd)).reshape(B, Skv, K, hd)
    v = (src @ p["wv"].reshape(D, K * hd)).reshape(B, Skv, K, hd)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if rope_cs is not None and kv_source is None:
        q = apply_rope(q, *rope_cs)
        k = apply_rope(k, *rope_cs)
    causal = causal and kv_source is None
    vector = per_row_positions(cache_pos)

    if page_table is not None:
        if cache is None or not vector or cache_pos.ndim != 1:
            raise ValueError("paged attention needs the pools and a (B,) "
                             "vector of first write positions")
        out = _paged_attention(cfg, q, k, v, cache, cache_pos, page_table,
                               kv_write_mask, window, impl)
        new_cache = cache
    elif cache is not None and vector:
        if cache_pos.ndim != 1 or S != 1:
            raise ValueError("vector decode takes one token per row and a "
                             "(B,) vector of cache positions")
        ck, cv = cache["k"], cache["v"]
        nk, nv = k[:, 0].to(ck.dtype), v[:, 0].to(cv.dtype)
        if impl == "kernel":
            out = kernel_ops.decode_attention_fused(
                q[:, 0], ck, cv, nk, nv, cache_pos, window,
                logit_cap=cfg.attn_softcap)[:, None]
        elif impl == "plain":
            rows = torch.arange(B, device=x.device)
            ck[rows, cache_pos] = nk
            cv[rows, cache_pos] = nv
            out = decode_attention(q, ck, cv, pos=cache_pos, window=window,
                                   logit_cap=cfg.attn_softcap)
        else:
            raise ValueError(f"decode impl {impl!r} not in {DECODE_IMPLS}")
        new_cache = cache
    elif cache is not None:
        if cache_pos is None or S != 1 or kv_source is not None:
            raise ValueError("decode takes one token per row at a scalar "
                             "or (B,) cache position, and no kv_source")
        cp = int(cache_pos)
        ck, cv = cache["k"], cache["v"]
        ck[:, cp] = k[:, 0].to(ck.dtype)
        cv[:, cp] = v[:, 0].to(cv.dtype)
        out = _attend(cfg, q, ck, cv, causal=causal, window=window,
                      impl=impl, q_offset=cp, kv_len=cp + 1)
        new_cache = cache
    else:
        out = _attend(cfg, q, k, v, causal=causal, window=window, impl=impl)
        new_cache = {"k": k, "v": v} if return_kv else None
    y = out.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)
    return y, new_cache


def cache_defs(cfg: ModelConfig, batch: int, max_len: int,
               layers: int) -> ParamDefs:
    """KV cache ParamDefs (stacked over layers)."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (layers, batch, max_len, K, hd)
    axes = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {
        "k": ParamDef(shape, axes, init="zeros"),
        "v": ParamDef(shape, axes, init="zeros"),
    }


def paged_cache_defs(cfg: ModelConfig, num_pages: int, page_size: int,
                     layers: int) -> ParamDefs:
    """Paged KV pool ParamDefs (stacked over layers): one physical pool
    ``(num_pages, page_size, K, hd)`` per layer, addressed through the
    engine's page tables.  ``num_pages`` INCLUDES the trailing TRASH page
    (index ``num_pages - 1``) that absorbs masked writes."""
    K, hd = cfg.num_kv_heads, cfg.head_dim
    shape = (layers, num_pages, page_size, K, hd)
    axes = ("layers", "kv_pages", "kv_page_rows", "kv_heads", "head_dim")
    return {
        "k": ParamDef(shape, axes, init="zeros"),
        "v": ParamDef(shape, axes, init="zeros"),
    }
