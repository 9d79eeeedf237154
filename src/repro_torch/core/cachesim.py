"""Trace-driven cache simulation driver (GPGPU-Sim replacement, §3.4).

Generates synthetic L2 access traces with power-law reuse distances (the
empirically observed GPU locality shape) and runs them through the
set-associative LRU simulator at several capacities, producing the
DRAM-access-reduction curve that cross-validates the analytical miss
model (core/dram.py).

Two simulation paths:

- ``simulate_ladder``, the batched engine: one kernel launch
  (``kernels.ops.cache_sim_ladder``) evaluates every (workload trace x
  capacity rung) pair, returning a (W, L, 2) [hits, misses] tensor.  The
  default rung sequence is the half-octave ladder the iso-area search
  sweeps (``core.sweep.capacity_ladder``).
- ``simulate_reference``, the per-point path (one ``kernels.ops.cache_sim``
  launch per capacity over set ids and tags computed on the host), the
  bit-exact parity baseline of the engine.

Traces are made on the host with numpy's ``RandomState``, so they are
bitwise those of the reference package for the same seed.  On a CUDA
device ``use_kernel=True`` launches the CUDA kernels (or raises); on the
CPU, and with ``use_kernel=False`` on any device, the plain PyTorch
version runs.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.constants import GPU_L2_MB, LINE_BYTES, MB
from repro_torch.core.dram import reduction_pct_from_misses
from repro_torch.core.sweep import capacity_ladder
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.cache_sim import (  # noqa: F401 (re-exported)
    cache_sim_ladder_plain, cache_sim_plain, largest_divisor_tile)

#: Documented analytic-vs-trace validation tolerance: the simulated Fig-7
#: DRAM-access reduction must sit within this many percentage points of
#: the power-law model's prediction on zipf traffic.
ANALYTIC_TOL_PCT = 6.0


def synthetic_trace(n: int, footprint_lines: int, *, theta: float = 1.186,
                    seed: int = 0) -> np.ndarray:
    """Independent-reference zipf(theta) line trace.

    Under Che's approximation an LRU cache of C lines misses on the tail
    P(rank > C) ~ C^(1 - theta); theta = 1.186 matches the paper-fitted
    power-law miss exponent alpha = 0.186 (core/dram.py) by construction;
    the simulator then *validates* that a 16-way set-associative cache
    actually behaves like the analytical model on such traffic.
    """
    rng = np.random.RandomState(seed)
    ranks = rng.zipf(theta, size=n) % footprint_lines
    # decorrelate rank -> line id so popular lines spread across sets
    return ((ranks * 2654435761) % footprint_lines).astype(np.int64)


def synthetic_traces(n: int, footprint_lines: int, *,
                     seeds: Sequence[int] = (0,),
                     theta: float = 1.186) -> np.ndarray:
    """Stack of workload traces, one per seed: (len(seeds), n)."""
    return np.stack([synthetic_trace(n, footprint_lines, theta=theta,
                                     seed=s) for s in seeds])


def capacity_lines(capacity_mb: float, *, scale: int = 1) -> int:
    """Cache capacity in lines at 1:``scale`` (power-law traffic is
    scale-free, so miss *ratios* are preserved under scaling)."""
    return int(capacity_mb * MB) // (LINE_BYTES * scale)


def _ladder_sets(capacities_mb: Sequence[float], *, scale: int,
                 ways: int) -> Tuple[int, ...]:
    return tuple(max(1, capacity_lines(c, scale=scale) // ways)
                 for c in capacities_mb)


def simulate_reference(trace: np.ndarray, cap_lines: int, *,
                       ways: int = 16, use_kernel: bool = True,
                       device: DeviceLike = None) -> Tuple[int, int]:
    """(hits, misses) of one trace against one LRU cache size.

    Per-point path: set ids / tags computed on the host, one kernel launch
    per capacity.  The parity baseline for ``simulate_ladder``.
    """
    dev = resolve_device(device)
    num_sets = max(1, cap_lines // ways)
    set_ids = torch.from_numpy((trace % num_sets).astype(np.int32)).to(dev)
    tags = torch.from_numpy((trace // num_sets).astype(np.int32)).to(dev)
    if use_kernel:
        counts = ops.cache_sim(set_ids, tags, num_sets=num_sets, ways=ways)
    else:
        counts = cache_sim_plain(set_ids, tags, num_sets=num_sets,
                                 ways=ways)
    h, m = counts.tolist()
    return int(h), int(m)


def simulate_ladder(traces: np.ndarray,
                    capacities_mb: Optional[Sequence[float]] = None, *,
                    scale: int = 1, ways: int = 16,
                    use_kernel: bool = True,
                    device: DeviceLike = None) -> np.ndarray:
    """Batched trace-driven sweep: (workloads x capacity ladder) in one call.

    ``traces`` is (W, T) line ids (a single (T,) trace is promoted);
    ``capacities_mb`` defaults to the iso-area search ladder
    (``sweep.capacity_ladder()``).  Returns an (W, L, 2) int64 array of
    [hits, misses] counts, bit-exact with ``simulate_reference`` per point.
    """
    dev = resolve_device(device)
    caps = tuple(capacities_mb if capacities_mb is not None
                 else capacity_ladder())
    traces = np.atleast_2d(np.asarray(traces))
    if traces.size and (traces.min() < 0 or traces.max() >= 2 ** 31):
        # the kernel runs in int32; a wrapped-negative id would make
        # tag == -1 collide with the EMPTY sentinel and fake cold hits
        raise ValueError(
            "trace line ids must fit int32 (0 <= id < 2**31); got range "
            f"[{traces.min()}, {traces.max()}]")
    ladder = _ladder_sets(caps, scale=scale, ways=ways)
    lines = torch.from_numpy(traces.astype(np.int32)).to(dev)
    if use_kernel:
        counts = ops.cache_sim_ladder(lines, num_sets=ladder, ways=ways)
    else:
        counts = cache_sim_ladder_plain(lines, ladder, ways=ways)
    return counts.cpu().numpy().astype(np.int64)


def dram_reduction_curve(capacities_mb: Sequence[float] = (3, 6, 12, 24),
                         *, trace_len: int = 400_000, scale: int = 32,
                         footprint_mb: float = 256.0, ways: int = 16,
                         use_kernel: bool = True, seed: int = 0,
                         device: DeviceLike = None) -> Dict[float, float]:
    """Simulated Fig-7 analogue: % DRAM (miss) reduction vs the first
    capacity, from one whole-ladder batch.

    Runs at 1:``scale`` capacity scale (power-law traffic is scale-free, so
    reduction percentages are preserved) to keep trace lengths tractable.
    """
    trace = synthetic_trace(
        trace_len, int(footprint_mb * MB) // (LINE_BYTES * scale), seed=seed)
    counts = simulate_ladder(trace, capacities_mb, scale=scale, ways=ways,
                             use_kernel=use_kernel, device=device)
    miss = counts[0, :, 1].astype(float)
    return {c: reduction_pct_from_misses(m, miss[0])
            for c, m in zip(capacities_mb, miss)}


def trace_dram_scale(capacities_mb: Sequence[float],
                     base_mb: float = GPU_L2_MB, *,
                     trace_len: int = 120_000, scale: int = 32,
                     footprint_mb: float = 256.0, ways: int = 16,
                     seed: int = 0, use_kernel: bool = True,
                     device: DeviceLike = None) -> Dict[float, float]:
    """Trace-driven DRAM-transaction multipliers vs ``base_mb``.

    The simulator-backed drop-in for ``core.dram.dram_scale``: one batched
    ladder run over {base} | {capacities} yields miss(C) / miss(base) for
    every requested capacity; ``core.iso.iso_area`` consumes it in
    ``dram_model="trace"`` mode.
    """
    caps = (float(base_mb),) + tuple(float(c) for c in capacities_mb
                                     if float(c) != float(base_mb))
    trace = synthetic_trace(
        trace_len, int(footprint_mb * MB) // (LINE_BYTES * scale), seed=seed)
    counts = simulate_ladder(trace, caps, scale=scale, ways=ways,
                             use_kernel=use_kernel, device=device)
    miss = counts[0, :, 1].astype(float)
    scales = {c: m / miss[0] for c, m in zip(caps, miss)}
    return {float(c): scales[float(c)] for c in capacities_mb}
