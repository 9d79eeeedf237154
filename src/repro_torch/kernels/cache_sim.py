"""Set-associative LRU cache simulation: plain PyTorch versions + CUDA
launchers.

Replaces ``repro/kernels/cache_sim.py``: ``_cachesim_kernel`` (per point,
``cache_sim``: one cache size over precomputed set ids and tags) and
``_ladder_kernel`` (``cache_sim_ladder``: every (trace x ladder rung) pair
in one call, set and tag derived from raw line ids).  The CUDA kernels
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
from typing import Optional, Sequence, Tuple

import torch

EMPTY = -1            # empty-way tag sentinel
MAX_WAYS = 16         # ways the CUDA kernels hold per set (registers)
MAX_TILE = 1024       # threads per block of the CUDA walk
TILE = 256            # sets per tile the wrappers choose by default
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
#
# ``csrc/cache_sim.cu`` buckets each problem's accesses by set (LSD radix
# passes), drops the accesses that repeat their set's previous tag (hits on
# the most recently used way), and walks each set's remaining accesses with
# one thread.  A problem is one trace against one set count: the per-point
# call is one, the ladder W x L (problem q: rung q // W, trace q % W).


SCRATCH_CAP = 2 ** 32   # bytes of scratch a ladder call groups its problems in
MAX_GROUP = 65535       # problems per group (the kernels' grid.y)
RADIX_BITS = 8


def largest_divisor_tile(num_sets: int, sets_tile: int = TILE) -> int:
    """Largest set-tile <= ``sets_tile`` that divides ``num_sets`` (the
    default ``sets_tile`` of the per-point call, as the JAX signature
    has it)."""
    for tile in range(min(int(sets_tile), int(num_sets)), 0, -1):
        if num_sets % tile == 0:
            return tile
    return 1


def ladder_tile(num_sets_ladder: Sequence[int], sets_tile: int) -> int:
    """The walk's block size over a ladder: ``sets_tile`` cut to the
    largest rung, as the Pallas kernel cuts its tile of sets.  Raises on
    an empty ladder or a rung of no sets."""
    ladder = tuple(int(n) for n in num_sets_ladder)
    if not ladder or min(ladder) < 1:
        raise ValueError(f"bad set-count ladder {ladder!r}")
    if max(ladder) >= 2 ** 31:
        raise ValueError(f"set counts must fit int32; got {max(ladder)}")
    return min(int(sets_tile), max(ladder))


def radix_passes(num_sets: int) -> int:
    """Bucketing passes of the CUDA kernels for ``num_sets`` sets."""
    return -(-(int(num_sets) - 1).bit_length() // RADIX_BITS)


def stage_names(max_ns: int) -> Tuple[str, ...]:
    """The CUDA kernels of one call over a ladder whose largest rung has
    ``max_ns`` sets, in launch order."""
    names = []
    for p in range(radix_passes(max_ns)):
        names += [f"histogram {p}", f"scan {p}", f"scatter {p}"]
    return tuple(names + ["collapse count", "collapse scan",
                          "collapse write", "walk"])


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


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch_cuda(fns, set_ids, tags, num_sets: int, ways: int,
                sets_tile: int) -> torch.Tensor:
    """Run ``cache_sim`` from ``csrc/cache_sim.cu`` (``fns``: it and
    ``cache_sim_scratch_bytes``) over one cache, walk blocks of
    ``sets_tile`` threads.  Returns (2,) int64 [hits, misses]."""
    run, scratch_bytes = fns
    T, dev = set_ids.numel(), set_ids.device
    nbytes = scratch_bytes(1, T, num_sets, 0)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    out = torch.empty(2, dtype=torch.int32, device=dev)
    err = run(set_ids.data_ptr(), tags.data_ptr(), out.data_ptr(),
              scratch.data_ptr(), nbytes, T, num_sets, sets_tile, ways,
              _stream(dev))
    if err:
        raise RuntimeError(f"cache_sim launch failed: CUDA error {err}")
    return out.to(torch.int64)


def ladder_groups(n_problems: int, bytes_of) -> Tuple[int, int]:
    """(problems per group, scratch bytes of a group): as many problems as
    fit ``SCRATCH_CAP`` (``bytes_of(n)`` the scratch of n problems), at
    least one and at most ``MAX_GROUP``."""
    size = max(1, min(n_problems, MAX_GROUP,
                      SCRATCH_CAP // max(bytes_of(1), 1)))
    while size > 1 and bytes_of(size) > SCRATCH_CAP:
        size -= 1
    return size, bytes_of(size)


def launch_ladder_cuda(fns, traces, num_sets_ladder: Sequence[int],
                       ways: int, sets_tile: int,
                       stage_ms: Optional[list] = None) -> torch.Tensor:
    """Run ``cache_sim_ladder`` from ``csrc/cache_sim.cu`` (``fns``: it
    and ``cache_sim_scratch_bytes``) over every (trace, rung) problem, in
    groups whose scratch stays under ``SCRATCH_CAP`` (a problem alone may
    pass it: about 8.2 bytes an access), walk blocks of the tile
    ``ladder_tile`` cuts.  With ``stage_ms`` (a list, one group only) the
    kernels are timed between CUDA events and their ms appended in the
    order of ``stage_names``.  Returns (W, L, 2) int64 [hits, misses]."""
    run, scratch_bytes = fns
    W, T = traces.shape
    dev = traces.device
    ladder = tuple(int(n) for n in num_sets_ladder)
    tile = ladder_tile(ladder, sets_tile)
    L, max_ns = len(ladder), max(ladder)
    P = W * L
    size, nbytes = ladder_groups(
        P, lambda n: scratch_bytes(n, T, max_ns, 1))
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    ns = torch.tensor(ladder, dtype=torch.int32).to(dev)
    out = torch.empty(P, 2, dtype=torch.int32, device=dev)
    times = None
    if stage_ms is not None:
        if size < P:
            raise ValueError("stage timing takes a ladder of one group")
        times = (ctypes.c_float * len(stage_names(max_ns)))()
    for q0 in range(0, P, size):
        n = min(size, P - q0)
        err = run(traces.data_ptr(), ns.data_ptr(), out[q0:].data_ptr(),
                  scratch.data_ptr(), nbytes, W, T, q0, n, max_ns, tile,
                  ways, times, _stream(dev))
        if err:
            raise RuntimeError(f"cache_sim_ladder launch failed: CUDA "
                               f"error {err}")
    if times is not None:
        stage_ms.extend(float(t) for t in times)
    return out.view(L, W, 2).transpose(0, 1).to(torch.int64)


ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
LADDER_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
SCRATCH_ARGTYPES = [ctypes.c_int] * 4
