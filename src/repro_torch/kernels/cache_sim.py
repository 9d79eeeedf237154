"""Set-associative LRU cache simulation: plain PyTorch versions + CUDA
launchers.

Replaces ``repro/kernels/cache_sim.py``: ``_cachesim_kernel`` (per point,
``cache_sim``: one cache size over precomputed set ids and tags) and
``_ladder_kernel`` (``cache_sim_ladder``: every (trace x ladder rung) pair
in one launch, set and tag derived from raw line ids).  The CUDA kernels
are ``csrc/cache_sim.cu``.

LRU semantics, shared by every version and bit-exact with the reference:
tags start at ``EMPTY`` (-1) and ages at 0; a hit is the lowest way whose
tag matches; on a miss the victim is the first way of maximum age (so
empty ways fill in order 0, 1, 2, ...); the touched way's age becomes 0
and every other way of the row ages by one, empty ways included.

The plain version is independent of the kernels' formulation: it sorts the
accesses stably by set, then processes "round r" (the r-th access of every
set) for all sets at once with tensor ops on (sets, ways) state.  Sets are
independent and the stable sort keeps each set's order, so this is exact.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

EMPTY = -1            # empty-way tag sentinel
MAX_WAYS = 16         # ways the CUDA kernels hold per set (registers)
MAX_TILE = 1024       # sets per block: one thread per set
TILE = 256            # sets per block the wrappers choose by default
MAX_LEN = 2 ** 31 - 4097   # trace length the kernels' int offsets reach


# --------------------------------------------------------------- plain


def _lru_rounds(gset: torch.Tensor, tags: torch.Tensor, n_sets: int,
                ways: int) -> torch.Tensor:
    """Exact LRU over accesses to ``n_sets`` independent sets.

    ``gset`` (N,) int64 set of each access, ``tags`` (N,) its tag, both in
    trace order.  Returns (n_sets, 2) int64 [hits, misses] per set.
    """
    dev = gset.device
    n = gset.numel()
    counts = torch.zeros(n_sets, 2, dtype=torch.int64, device=dev)
    if n == 0:
        return counts
    order = torch.argsort(gset, stable=True)
    gs, tg = gset[order], tags[order].to(torch.int64)
    per_set = torch.bincount(gs, minlength=n_sets)
    start = torch.cumsum(per_set, 0) - per_set
    rank = torch.arange(n, device=dev) - start[gs]     # r-th access of set
    by_round = torch.argsort(rank, stable=True)
    gs, tg = gs[by_round], tg[by_round]
    sizes = torch.bincount(rank).tolist()

    # per way: its tag and the round of its last touch.  Empty ways carry
    # round -1, older than any touched way, so the first way of the least
    # recent round is the first way of maximum age and empty ways fill in
    # order; a row holds each tag at most once, so a match is unique.
    tag_st = torch.full((n_sets * ways,), EMPTY, dtype=torch.int64,
                        device=dev)
    last = torch.full((n_sets * ways,), -1, dtype=torch.int64, device=dev)
    way_ids = torch.arange(ways, device=dev)
    row0 = gs * ways                        # flat index of each set's way 0
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    off = 0
    for r, size in enumerate(sizes):
        first, t = row0[off:off + size], tg[off:off + size]
        row = first[:, None] + way_ids
        h, hit_way = (tag_st[row] == t[:, None]).max(1)
        way = torch.where(h, hit_way, last[row].argmin(1))
        slot = first + way
        tag_st[slot] = t
        last[slot] = r
        hit[off:off + size] = h
        off += size
    counts.index_add_(0, gs, torch.stack([hit, ~hit], 1).to(torch.int64))
    return counts


def cache_sim_plain(set_ids: torch.Tensor, tags: torch.Tensor, *,
                    num_sets: int, ways: int) -> torch.Tensor:
    """(2,) int64 [hits, misses] of one trace of precomputed set ids and
    tags against one LRU cache."""
    per_set = _lru_rounds(set_ids.to(torch.int64), tags, int(num_sets),
                          int(ways))
    return per_set.sum(0)


def cache_sim_ladder_plain(traces: torch.Tensor,
                           num_sets_ladder: Sequence[int], *,
                           ways: int) -> torch.Tensor:
    """(W, L, 2) int64 [hits, misses] of every (trace, rung) pair; set and
    tag of a line are ``line % ns`` and ``line // ns`` for rung ``ns``."""
    traces = traces.to(torch.int64)
    W, T = traces.shape
    ladder = [int(n) for n in num_sets_ladder]
    L = len(ladder)
    ns = torch.tensor(ladder, dtype=torch.int64, device=traces.device)
    # every (trace, rung) pair owns its own block of sets
    first = torch.cumsum(ns, 0) - ns                               # (L,)
    total = int(ns.sum())
    offset = (torch.arange(W, device=traces.device)[:, None] * total
              + first[None, :])                                     # (W, L)
    lines = traces[:, None, :]                                      # (W,1,T)
    gset = (lines % ns[None, :, None] + offset[:, :, None]).reshape(-1)
    tags = (lines // ns[None, :, None]).expand(W, L, T).reshape(-1)
    per_set = _lru_rounds(gset, tags, W * total, int(ways))
    group = torch.repeat_interleave(
        torch.arange(W * L, device=traces.device), ns.repeat(W))
    out = torch.zeros(W * L, 2, dtype=torch.int64, device=traces.device)
    out.index_add_(0, group, per_set)
    return out.reshape(W, L, 2)


# --------------------------------------------------------------- CUDA


def largest_divisor_tile(num_sets: int, sets_tile: int = TILE) -> int:
    """Largest set-tile <= ``sets_tile`` that divides ``num_sets`` (the
    per-point kernel takes whole tiles only)."""
    for tile in range(min(int(sets_tile), int(num_sets)), 0, -1):
        if num_sets % tile == 0:
            return tile
    return 1


def ladder_tiles(num_sets_ladder: Sequence[int], sets_tile: int
                 ) -> Tuple[int, Tuple[int, ...], Tuple[int, ...],
                            Tuple[int, ...]]:
    """(tile, per-tile set count, per-tile first set, per-tile rung) over
    a ladder: rung ``l`` with ``ns`` sets contributes ``ceil(ns / tile)``
    tiles; the kernel ignores accesses outside ``[base, base + tile)``, so
    ``ns`` need not be a multiple of the tile."""
    ladder = tuple(int(n) for n in num_sets_ladder)
    if not ladder or min(ladder) < 1:
        raise ValueError(f"bad set-count ladder {ladder!r}")
    tile = min(int(sets_tile), max(ladder))
    ns_of, base_of, rung_of = [], [], []
    for l, ns in enumerate(ladder):
        for base in range(0, ns, tile):
            ns_of.append(ns)
            base_of.append(base)
            rung_of.append(l)
    return tile, tuple(ns_of), tuple(base_of), tuple(rung_of)


def _check_common(ways: int, tile: int) -> None:
    if not 1 <= ways <= MAX_WAYS:
        raise ValueError(f"ways must be in [1, {MAX_WAYS}] for the CUDA "
                         f"kernel; got {ways}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"sets_tile must be in [1, {MAX_TILE}]; got {tile}")


def _check_int32(name: str, x: torch.Tensor, ndim: int) -> None:
    if x.ndim != ndim or x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d int32 "
                         f"tensor; got {tuple(x.shape)} {x.dtype}")
    if x.shape[-1] > MAX_LEN:
        raise ValueError(f"{name} holds {x.shape[-1]} accesses; the kernels "
                         f"take at most {MAX_LEN}")


def check_args(set_ids, tags, num_sets: int, ways: int,
               sets_tile: int) -> None:
    _check_int32("set_ids", set_ids, 1)
    _check_int32("tags", tags, 1)
    if tags.shape != set_ids.shape:
        raise ValueError(f"tags {tuple(tags.shape)} and set_ids "
                         f"{tuple(set_ids.shape)} differ in shape")
    _check_common(ways, sets_tile)
    if num_sets < 1 or num_sets % sets_tile:
        raise ValueError(f"num_sets {num_sets} must be a positive multiple "
                         f"of sets_tile {sets_tile}")


def check_ladder_args(traces, ways: int, sets_tile: int) -> None:
    _check_int32("traces", traces, 2)
    if not 1 <= traces.shape[0] <= 65535:
        raise ValueError(f"the kernel takes 1 to 65535 traces; got "
                         f"{traces.shape[0]}")
    _check_common(ways, sets_tile)


def launch_cuda(fn, set_ids, tags, num_sets: int, ways: int,
                sets_tile: int) -> torch.Tensor:
    """Launch ``cache_sim`` from ``csrc/cache_sim.cu``: one block per tile
    of ``sets_tile`` sets.  Returns (2,) int64 [hits, misses]."""
    n_tiles = num_sets // sets_tile
    dev = set_ids.device
    out = torch.empty(n_tiles, 2, dtype=torch.int32, device=dev)
    err = fn(set_ids.data_ptr(), tags.data_ptr(), out.data_ptr(),
             set_ids.numel(), n_tiles, sets_tile, ways,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cache_sim launch failed: CUDA error {err}")
    return out.sum(0, dtype=torch.int64)


def launch_ladder_cuda(fn, traces, num_sets_ladder: Sequence[int],
                       ways: int, sets_tile: int) -> torch.Tensor:
    """Launch ``cache_sim_ladder`` from ``csrc/cache_sim.cu``: one block
    per (trace, rung tile).  Returns (W, L, 2) int64 [hits, misses]."""
    W, T = traces.shape
    dev = traces.device
    tile, ns_of, base_of, rung_of = ladder_tiles(num_sets_ladder, sets_tile)
    G = len(ns_of)
    meta = torch.tensor([ns_of, base_of], dtype=torch.int32).to(dev)
    out = torch.empty(W, G, 2, dtype=torch.int32, device=dev)
    err = fn(traces.data_ptr(), meta[0].data_ptr(), meta[1].data_ptr(),
             out.data_ptr(), W, T, G, tile, ways,
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"cache_sim_ladder launch failed: CUDA error "
                           f"{err}")
    # tile -> rung reduction, in int64
    rung = torch.tensor(rung_of, dtype=torch.int64).to(dev)
    per_rung = torch.zeros(len(num_sets_ladder), W, 2, dtype=torch.int64,
                           device=dev)
    per_rung.index_add_(0, rung, out.transpose(0, 1).to(torch.int64))
    return per_rung.transpose(0, 1).contiguous()


ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
LADDER_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
