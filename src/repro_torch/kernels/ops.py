"""Dispatch wrappers for the port's kernels.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the CUDA kernel (built at first use) or raises; any other device
raises.  There is no fallback from the kernel to the plain version.

``launches`` counts, per kernel, the launches the wrappers made: each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cache_sim as _cs
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import sampling as _sm

launches: Dict[str, int] = {"decode_attention": 0, "fused_sample": 0,
                            "cache_sim": 0, "cache_sim_ladder": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    another device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


def decode_attention(q, k, v, pos, window: int = 0, *,
                     logit_cap: float = 0.0):
    """Decode attention over caches that already hold the new row.

    q (B,H,hd); k/v (B,L,K,hd); pos (B,) int32; window int (<= 0 global)
    -> o (B,H,hd)."""
    if not _on_cuda(q, k, v, pos):
        return _da.decode_attention_plain(q, k, v, pos, window,
                                          logit_cap=logit_cap)
    _da.check_args(q, k, v, None, None, pos, window)
    fn = _build.function("decode_attention", "decode_attention",
                         _da.ARGTYPES)
    out = _da.launch_cuda(fn, q, k, v, None, None, pos, window, logit_cap)
    launches["decode_attention"] += 1
    return out


def decode_attention_fused(q, k, v, new_k, new_v, pos, window: int = 0, *,
                           logit_cap: float = 0.0):
    """Write ``new_k/new_v`` (B,K,hd) into the caches at each row's own
    ``pos[b]`` and attend ``k_idx <= pos[b]``, in one launch.

    The caches are updated IN PLACE (the JAX kernel returned aliased
    buffers); every row other than ``(b, pos[b])`` keeps its bits.
    Returns o (B,H,hd)."""
    if not _on_cuda(q, k, v, new_k, new_v, pos):
        return _da.decode_attention_fused_plain(
            q, k, v, new_k, new_v, pos, window, logit_cap=logit_cap)
    _da.check_args(q, k, v, new_k, new_v, pos, window)
    fn = _build.function("decode_attention", "decode_attention",
                         _da.ARGTYPES)
    out = _da.launch_cuda(fn, q, k, v, new_k, new_v, pos, window,
                          logit_cap)
    launches["decode_attention"] += 1
    return out


def fused_sample(logits, temps, key):
    """One-launch greedy/temperature next-token sample.

    logits (B,V) f32; temps (B,) f32 (<= 0 greedy, bitwise first-occurrence
    argmax; > 0 Gumbel-max); key (2,) int64 uint32 words -> (B,) int32."""
    if not _on_cuda(logits, temps, key):
        return _sm.fused_sample_plain(logits, temps, key)
    _sm.check_args(logits, temps, key)
    fn = _build.function("sampling", "fused_sample", _sm.ARGTYPES)
    out = _sm.launch_cuda(fn, logits, temps, key)
    launches["fused_sample"] += 1
    return out


def cache_sim(set_ids, tags, *, num_sets: int, ways: int,
              sets_tile: Optional[int] = None):
    """LRU hits and misses of one trace of precomputed set ids and tags
    (T,) int32 against a cache of ``num_sets`` x ``ways``; one block per
    tile of ``sets_tile`` sets (``num_sets`` a multiple of it; by default
    the largest divisor of ``num_sets`` up to 256).  Returns (2,) int64
    [hits, misses]."""
    if not _on_cuda(set_ids, tags):
        return _cs.cache_sim_plain(set_ids, tags, num_sets=num_sets,
                                   ways=ways)
    if sets_tile is None:
        sets_tile = _cs.largest_divisor_tile(num_sets)
    _cs.check_args(set_ids, tags, num_sets, ways, sets_tile)
    fn = _build.function("cache_sim", "cache_sim", _cs.ARGTYPES)
    out = _cs.launch_cuda(fn, set_ids, tags, num_sets, ways, sets_tile)
    launches["cache_sim"] += 1
    return out


def cache_sim_ladder(traces, *, num_sets: Sequence[int], ways: int,
                     sets_tile: int = _cs.TILE):
    """LRU hits and misses of every (trace, rung) pair in one launch:
    traces (W, T) int32 line ids, ``num_sets`` the per-rung set counts;
    one block per tile of ``sets_tile`` sets (cut to the largest rung), a
    rung's last tile may be partial.  Returns (W, L, 2) int64 [hits,
    misses]."""
    if not _on_cuda(traces):
        return _cs.cache_sim_ladder_plain(traces, num_sets, ways=ways)
    _cs.check_ladder_args(traces, ways, sets_tile)
    fn = _build.function("cache_sim", "cache_sim_ladder",
                         _cs.LADDER_ARGTYPES)
    out = _cs.launch_ladder_cuda(fn, traces, num_sets, ways, sets_tile)
    launches["cache_sim_ladder"] += 1
    return out
