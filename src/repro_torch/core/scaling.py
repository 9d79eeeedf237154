"""Scalability analysis (paper §4.3, Figs 10-13).

Each memory is EDAP-tuned independently at every capacity (1..32 MB), then
evaluated on every workload; results are normalized to SRAM at the same
capacity.  DRAM terms are held at the 3MB-baseline counts (iso-capacity
convention) so the curves isolate cache scalability.

``workload_scaling`` consumes the whole traffic tensor at once: profiles
are stacked into (P,) tensors, each memory's tuned PPA across the capacity
grid into (C, 1) tensors, and one broadcasted array-energy pass
(``energy.evaluate_arrays``) yields the (C, P) relative-metric tensor per
memory, with no per-(capacity, workload) Python loops.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import energy as en
from repro_torch.core.cache_model import CachePPA
from repro_torch.core.profiles import MemoryProfile, paper_profiles
from repro_torch.core.tuner import CAPACITIES_MB, MEMORIES, tune_all
from repro_torch.device import DeviceLike, resolve_device


def ppa_scaling(capacities: Sequence[float] = CAPACITIES_MB,
                device: DeviceLike = None
                ) -> Dict[str, Dict[float, CachePPA]]:
    """Fig 10: area / latency / energy vs capacity per memory: one batched
    sweep over the full (memory x capacity) grid."""
    return tune_all(MEMORIES, capacities, device)


def _ppa_columns(cfgs: Dict[float, CachePPA], capacities: Sequence[float],
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Stack one memory's tuned PPA over the capacity grid as (C, 1)
    tensors, broadcastable against (P,) profile tensors."""
    return {f: torch.tensor([[getattr(cfgs[c], f)] for c in capacities],
                            dtype=torch.float32, device=device)
            for f in en.PPA_ENERGY_FIELDS}


def workload_scaling(profiles: Optional[List[MemoryProfile]] = None,
                     capacities: Sequence[float] = CAPACITIES_MB,
                     mode_filter: Optional[str] = None,
                     device: DeviceLike = None):
    """Figs 11-13: normalized energy / latency / EDP vs capacity.

    Returns {capacity: {mem: {metric: {mean, std, min}}}} across workloads.
    """
    dev = resolve_device(device)
    profiles = profiles or paper_profiles(device=dev)
    if mode_filter:
        profiles = [p for p in profiles if p.mode == mode_filter]
    cfgs = ppa_scaling(capacities, dev)
    reads, writes, dram = (
        torch.tensor([getattr(p, f) for p in profiles], dtype=torch.float32,
                     device=dev)
        for f in ("l2_reads", "l2_writes", "dram"))
    base = en.evaluate_arrays(reads, writes, dram,
                              _ppa_columns(cfgs["SRAM"], capacities, dev))
    metric_map = {"total": "total", "delay": "delay",
                  "edp": "edp_with_dram"}
    out: Dict[float, Dict[str, Dict[str, Dict[str, float]]]] = {
        c: {} for c in capacities}
    for m in ("STT", "SOT"):
        rep = en.evaluate_arrays(reads, writes, dram,
                                 _ppa_columns(cfgs[m], capacities, dev))
        rel = en.relative_arrays(base, rep)            # each (C, P)
        for k, src in metric_map.items():
            v = rel[src].cpu().numpy()
            mean, std, vmin = v.mean(1), v.std(1), v.min(1)
            for ci, c in enumerate(capacities):
                out[c].setdefault(m, {})[k] = {
                    "mean": float(mean[ci]),
                    "std": float(std[ci]),
                    "min": float(vmin[ci]),
                }
    return out
