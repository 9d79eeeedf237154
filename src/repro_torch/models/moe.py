"""Top-k MoE layer with capacity dispatch (torch counterpart of
``repro/models/moe.py``).

Dispatch is grouped by batch row, as in the JAX package: each row's S
tokens are routed, each assignment ranked within its expert in the order
of JAX's stable sort by expert, dropped beyond the per-row capacity
``C = capacity(cfg, S)``, gathered into an (experts, C, D) buffer per row,
run through the batched expert FFNs, and combined back weighted by the
router gates.  Every shape is fixed by (B, S), so a decode window runs the
layer without a host sync.

Three choices differ in mechanism, not in result, from the JAX code:

- the router's top-k is a stable descending sort (``jax.lax.top_k``
  breaks ties toward the lower expert index; ``torch.topk`` promises no
  order);
- an assignment's rank is the count of the row's earlier assignments to
  its expert (a cumulative sum of one-hot hits), which is its rank in
  the stable sort, so no sort and no inverse permutation is needed;
- the combine gathers each token's K expert outputs back and sums them
  in a fixed order, where JAX scatter-adds them: a scatter-add of f32
  rows on CUDA runs on atomics, whose order changes from run to run;
- the backward of both row gathers (tokens into the buffer, buffer rows
  back to the assignments) gathers too (``_GatherSlots``,
  ``_PickSlots``), in a fixed order, where autograd's would accumulate.

The expert products are ``torch.bmm`` over the padded experts; every
padded expert runs at capacity C, as the JAX design has it (a decode tick
reads every expert's weights).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamDef, ParamDefs, Params, activation
from repro_torch.sharding import constrain

# the logical axes of the (Ep, B*C, D) expert buffers: JAX's are (B, Ep, C,
# D) with ("batch", "experts", "capacity", "embed_act"); here the batch and
# capacity dims are one, which takes the batch's mesh axis
_BUF = ("experts", "batch", "embed_act")


def padded_experts(cfg: ModelConfig) -> int:
    """Experts padded to a multiple of 16 (granite: 40 -> 48); the dummy
    experts are never routed to.  Counts already divisible are kept."""
    E = cfg.num_experts
    return E if E % 16 == 0 else ((E + 15) // 16) * 16


def moe_param_defs(cfg: ModelConfig) -> ParamDefs:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    Ep = padded_experts(cfg)
    defs: ParamDefs = {
        "router": ParamDef((D, E), ("ffn_in", "experts"), scale=D ** -0.5),
        "w_up": ParamDef((Ep, D, F), ("experts", "ffn_in", "expert_ffn")),
        "w_down": ParamDef((Ep, F, D), ("experts", "expert_ffn", "ffn_in")),
    }
    if cfg.gated_mlp:
        defs["w_gate"] = ParamDef((Ep, D, F),
                                  ("experts", "ffn_in", "expert_ffn"))
    return defs


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    """Slots per expert in a group of ``group_tokens`` tokens, rounded up
    to a multiple of 8 and at least 8."""
    c = int(group_tokens * cfg.top_k * cfg.moe_capacity_factor
            / cfg.num_experts + 0.999)
    return max(8, -(-c // 8) * 8)


def route(cfg: ModelConfig, router: torch.Tensor, x: torch.Tensor):
    """f32 router: (probs (B, S, E), gates (B, S, K) renormalised,
    expert_idx (B, S, K) int64), the top k in descending order with ties
    toward the lower expert index."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_idx = top[..., :cfg.top_k], idx[..., :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, expert_idx


def aux_loss(cfg: ModelConfig, probs: torch.Tensor,
             expert_idx: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balancing loss over the whole batch: coef x E x
    sum(mean router prob x token fraction)."""
    B, S, E = probs.shape
    K = cfg.top_k
    me = probs.mean(dim=(0, 1))
    counts = probs.new_zeros(E)       # made like probs: a DTensor under one
    counts.index_add_(0, expert_idx.reshape(-1),
                      torch.ones(B * S * K, dtype=torch.float32,
                                 device=probs.device))
    ce = counts * (1.0 / (B * S * K))
    return cfg.router_aux_coef * E * torch.sum(me * ce)


@dataclasses.dataclass
class Dispatch:
    """The per-row dispatch of the (B, S*K) assignments, in token order
    (assignment i = s*K + k): ``keep`` rank < C, ``slot`` each kept
    assignment's row of the (Ep, B*C) expert buffer, ``e * B*C + b*C +
    rank`` (``Ep * B*C`` when dropped), and ``tokmap`` (Ep * B*C,) each
    buffer row's token ``b*S + s`` (``B*S``, a zero row, when empty)."""
    keep: torch.Tensor
    slot: torch.Tensor
    tokmap: torch.Tensor


def dispatch(cfg: ModelConfig, expert_idx: torch.Tensor,
             C: int) -> Dispatch:
    """Rank each row's assignments within their expert in token order,
    which is the order of JAX's stable sort by expert (a rank counts the
    row's earlier assignments to the same expert), drop ranks >= C and map
    the kept ones to buffer rows."""
    B, S, K = expert_idx.shape
    E, Ep = cfg.num_experts, padded_experts(cfg)
    dev = expert_idx.device
    e_flat = expert_idx.reshape(B, S * K)
    hit = e_flat[..., None] == torch.arange(E, device=dev)
    rank = torch.cumsum(hit, dim=1).gather(2, e_flat[..., None])[..., 0] - 1
    keep = rank < C
    rows = torch.arange(B, device=dev)[:, None]
    slot = torch.where(keep, e_flat * (B * C) + rows * C + rank,
                       Ep * B * C)
    # token b*S + s of assignment (b, s*K + k)
    tok = torch.arange(B * S * K, device=dev).view(B, S * K) // K
    tokmap = slot.new_full((Ep * B * C + 1,), B * S)
    tokmap.scatter_(0, slot.reshape(-1), tok.reshape(-1))  # drops collide
    if _tallies:
        _tallies[-1].append(((~keep).sum(), keep.numel()))
    return Dispatch(keep=keep, slot=slot, tokmap=tokmap[:-1])


def moe_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
              with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux loss or None).

    Groups are batch rows with capacity ``capacity(cfg, S)`` each; the
    aux loss is computed only when ``with_aux`` (the serve paths do not
    read it).  Everything but the expert products runs inside the
    profiler range ``moe_dispatch`` (JAX's named scope), so that a trace
    gives the dispatch's share of a tick."""
    B, S, D = x.shape
    C = capacity(cfg, S)
    with record_function("moe_dispatch"):
        probs, gates, expert_idx = route(cfg, p["router"], x)
        aux = aux_loss(cfg, probs, expert_idx) if with_aux else None
        d = dispatch(cfg, expert_idx, C)
        buf = _gather_slots(cfg, x, d, C)
    buf = constrain(buf, _BUF)
    out = constrain(_experts(cfg, p, buf), _BUF)
    with record_function("moe_dispatch"):
        return _combine(cfg, out, gates, d, C).to(x.dtype), aux


class _GatherSlots(torch.autograd.Function):
    """``x_pad[tokmap]``, the buffer rows' tokens, with a backward that
    gathers: each token's gradient is the sum over its K assignments of
    the buffer rows they filled (through ``slot``; a dropped one adds 0),
    in f32 in a fixed order.  Autograd's own backward of the index is a
    sorted accumulate that walks the rows sharing a source one after
    another, and every empty row shares the zero row."""

    @staticmethod
    def forward(ctx, x_pad, tokmap, slot, keep, K: int):
        ctx.save_for_backward(slot, keep)
        ctx.K = K
        return x_pad[tokmap]

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        B, SK = slot.shape
        D = g.shape[-1]
        rows = g[torch.clamp(slot, max=g.shape[0] - 1)]
        rows = torch.where(keep[..., None], rows, 0).float()
        gx = rows.view(B * SK // ctx.K, ctx.K, D).sum(1).to(g.dtype)
        return torch.cat([gx, gx.new_zeros((1, D))]), None, None, None, None


class _PickSlots(torch.autograd.Function):
    """``flat[min(slot, last row)]``, each assignment's expert output row
    (a dropped one reads the last row, masked after), with a backward
    that gathers: each buffer row's gradient is that of the one
    assignment that filled it, found by scattering the assignment ids
    into the rows (in the backward only), where autograd's own backward
    would accumulate every dropped assignment into the last row one after
    another."""

    @staticmethod
    def forward(ctx, flat, slot, keep):
        ctx.save_for_backward(slot, keep)
        ctx.rows = flat.shape[0]
        return flat[torch.clamp(slot, max=flat.shape[0] - 1)]

    @staticmethod
    def backward(ctx, g):
        slot, keep = ctx.saved_tensors
        B, SK = slot.shape
        n = B * SK
        owner = slot.new_full((ctx.rows + 1,), n)
        owner.scatter_(0, torch.where(keep, slot, ctx.rows).reshape(-1),
                       torch.arange(n, device=g.device))
        g_pad = torch.cat([g.reshape(n, -1), g.new_zeros((1, g.shape[-1]))])
        return g_pad[owner[:-1]], None, None


def _gather_slots(cfg: ModelConfig, x: torch.Tensor, d: Dispatch,
                  C: int) -> torch.Tensor:
    """The buffer rows' tokens as (Ep, B*C, D); an empty row is zeros."""
    B, S, D = x.shape
    x_pad = torch.cat([x.reshape(B * S, D), x.new_zeros((1, D))])
    return _GatherSlots.apply(x_pad, d.tokmap, d.slot, d.keep,
                              cfg.top_k).view(padded_experts(cfg), B * C, D)


def _experts(cfg: ModelConfig, p: Params, buf: torch.Tensor) -> torch.Tensor:
    """Every padded expert's FFN on its (B*C, D) rows, in the model
    dtype."""
    act = activation(cfg.mlp_act)
    up = torch.bmm(buf, p["w_up"])
    h = act(torch.bmm(buf, p["w_gate"])) * up if cfg.gated_mlp else act(up)
    h = constrain(h, ("experts", "batch", "expert_ffn"))
    return torch.bmm(h, p["w_down"])


def _combine(cfg: ModelConfig, out: torch.Tensor, gates: torch.Tensor,
             d: Dispatch, C: int) -> torch.Tensor:
    """Each token's K gated expert outputs, gathered back in token order
    and summed over K in f32 (a dropped assignment adds 0)."""
    B, SK = d.slot.shape
    D = out.shape[-1]
    picked = _PickSlots.apply(out.view(-1, D), d.slot, d.keep)
    picked = torch.where(d.keep[..., None], picked, 0).float()
    K = cfg.top_k
    return (picked * gates.reshape(B, SK, 1)).view(B, SK // K, K, D).sum(2)


_tallies: List[list] = []


@contextlib.contextmanager
def tally_drops() -> Iterator[list]:
    """Collect, for every dispatch run inside the block, (dropped
    assignments, assignments) as 0-d device tensors and ints (no host
    sync); ``dropped(t)`` sums them.  The tallies are a process-wide
    stack, as torch's grad mode is: the dispatch runs deep inside an
    engine's window, where no argument reaches it."""
    t: list = []
    _tallies.append(t)
    try:
        yield t
    finally:
        _tallies.pop()


def dropped(tally: list) -> Tuple[int, int]:
    """(dropped, total) assignments of a ``tally_drops`` list."""
    return (int(sum(int(n) for n, _ in tally)),
            int(sum(m for _, m in tally)))
