"""EDAP-optimal cache tuning: the paper's Algorithm 1.

For each memory type and capacity, candidate configurations are generated by
optimizing each single objective in O = {Read/Write Latency, Read/Write
Energy, Read/Write EDP, Area, Leakage} over the design grid, crossed with
the access types A = {Normal, Fast, Sequential}; the candidate minimizing
EDAP (energy x delay x area) wins.

This module is a thin wrapper over ``core.sweep``: ``tune_all`` /
``iso_capacity_configs`` / ``iso_area_capacity`` each issue ONE batched
sweep, with selections identical to the published pseudocode's loop
order.  ``tune_reference`` keeps the per-point loop as the ground truth
the batched engine is tested against.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Dict, Sequence

import torch

from repro_torch.core.cache_model import (ACCESS_TYPES, CAL, CachePPA,
                                          design_grid)
from repro_torch.core.sweep import (OPT_TARGETS, capacity_ladder,
                                    iso_area_search, sweep)
from repro_torch.device import DeviceLike, resolve_device

CAPACITIES_MB = (1, 2, 4, 8, 16, 32)
MEMORIES = ("SRAM", "STT", "SOT")


def _objective(ppa: CachePPA, opt: str) -> float:
    return {
        "read_latency": ppa.read_latency_ns,
        "write_latency": ppa.write_latency_ns,
        "read_energy": ppa.read_energy_nj,
        "write_energy": ppa.write_energy_nj,
        "read_edp": ppa.read_energy_nj * ppa.read_latency_ns,
        "write_edp": ppa.write_energy_nj * ppa.write_latency_ns,
        "area": ppa.area_mm2,
        "leakage": ppa.leakage_mw,
    }[opt]


def tune(mem: str, capacity_mb: float, cal=None,
         device: DeviceLike = None) -> CachePPA:
    """EDAP-optimal configuration for one (memory, capacity)."""
    dev = resolve_device(device)
    if cal is None:
        return _tune_cached(mem, float(capacity_mb), dev)
    return sweep((mem,), (capacity_mb,), cal, dev).config(mem, capacity_mb)


@lru_cache(maxsize=None)
def _tune_cached(mem: str, capacity_mb: float,
                 device: torch.device) -> CachePPA:
    # keyed on the device too: a result computed on one device is never
    # served for another
    return sweep((mem,), (capacity_mb,), device=device).config(mem,
                                                               capacity_mb)


def tune_reference(mem: str, capacity_mb: float, cal=None,
                   device: DeviceLike = None) -> CachePPA:
    """Per-point Algorithm 1 (Python loops over ``design_grid``): the
    ground truth the batched engine is tested against."""
    grid = design_grid(mem, float(capacity_mb), cal or CAL, device)
    best_q, best = float("inf"), None
    for opt in OPT_TARGETS:                      # Algorithm 1 line 9
        for acc in ACCESS_TYPES:                 # Algorithm 1 line 10
            sub = [p for p in grid if p.access_type == acc]
            cand = min(sub, key=lambda p: _objective(p, opt))
            q = cand.edap                        # line 11: calculate(EDAP)
            if q < best_q:                       # lines 12-13
                best_q, best = q, cand
    return best


def tune_all(memories: Sequence[str] = MEMORIES,
             capacities: Sequence[float] = CAPACITIES_MB,
             device: DeviceLike = None
             ) -> Dict[str, Dict[float, CachePPA]]:
    """Algorithm 1's outer loops: TunedConfig for every (mem, capacity),
    one batched sweep over the whole (memories x capacities) grid."""
    s = sweep(tuple(memories), tuple(capacities), device=device)
    return {m: {c: s.config(m, c) for c in capacities} for m in memories}


def iso_capacity_configs(capacity_mb: float = 3.0,
                         device: DeviceLike = None) -> Dict[str, CachePPA]:
    """Same-capacity SRAM/STT/SOT configs (paper Table 2, iso-capacity)."""
    s = sweep(MEMORIES, (capacity_mb,), device=device)
    return {m: s.config(m, capacity_mb) for m in MEMORIES}


def iso_area_capacity(mem: str, area_budget_mm2: float,
                      tol: float = 0.08, max_mb: float = 64.0,
                      device: DeviceLike = None) -> CachePPA:
    """Largest capacity of ``mem`` whose EDAP-tuned area fits the budget.

    The paper's iso-area method: SRAM's tuned 3MB area is the budget; the
    NVM capacity is grown until the area is exhausted.  The half-octave
    ladder is evaluated as one batched sweep.  Raises ``ValueError`` (with
    the budget in the message) when no capacity up to ``max_mb`` fits.
    """
    ladder = capacity_ladder(max_mb=max_mb)
    return iso_area_search((mem,), area_budget_mm2, tol, ladder,
                           device)[mem]
