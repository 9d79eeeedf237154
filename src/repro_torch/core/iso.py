"""Iso-capacity and iso-area analyses (paper §4.1 / §4.2, Figs 4-9).

Every analysis here consumes whole traffic tensors: the profile set is
stacked into (P,) read/write/DRAM tensors on the device and evaluated
against each memory's tuned PPA in one array-native energy computation
(``energy.evaluate_arrays``) instead of looping ``energy.evaluate`` per
(profile, memory) pair.  ``batch_sweep`` computes its whole batch grid
from a single engine evaluation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import energy as en
from repro_torch.core import traffic as tr
from repro_torch.core.cache_model import CachePPA
from repro_torch.core.constants import GPU_L2_MB
from repro_torch.core.dram import dram_scale
from repro_torch.core.profiles import MemoryProfile, paper_profiles
from repro_torch.core.sweep import iso_area_search
from repro_torch.core.tuner import iso_capacity_configs, tune
from repro_torch.device import DeviceLike, resolve_device

NVM_MEMS = ("STT", "SOT")


@dataclasses.dataclass
class IsoResult:
    """Per-workload normalized-to-SRAM metrics for STT and SOT."""
    workload: str
    metrics: Dict[str, Dict[str, float]]   # mem -> relative metrics


def _configs_iso_area(capacity_mb: float,
                      device: torch.device) -> Dict[str, CachePPA]:
    sram = tune("SRAM", capacity_mb, device=device)
    # one batched ladder sweep covering both NVMs; raises ValueError when
    # nothing fits the budget
    nvm = iso_area_search(NVM_MEMS, sram.area_mm2, device=device)
    return {"SRAM": sram, **nvm}


def _profile_arrays(profiles: Sequence[MemoryProfile],
                    device: torch.device):
    return tuple(torch.tensor([getattr(p, f) for p in profiles],
                              dtype=torch.float32, device=device)
                 for f in ("l2_reads", "l2_writes", "dram"))


def _relative_results(profiles: Sequence[MemoryProfile],
                      cfgs: Dict[str, CachePPA], device: torch.device,
                      dram_scales: Optional[Dict[str, float]] = None
                      ) -> List[IsoResult]:
    """Whole-tensor evaluation: one array-energy pass per memory over the
    stacked profile set, unpacked into per-workload results."""
    reads, writes, dram = _profile_arrays(profiles, device)
    base = en.evaluate_arrays(reads, writes, dram,
                              en.ppa_scalars(cfgs["SRAM"]))
    rel = {}
    for m in NVM_MEMS:
        d = dram * dram_scales[m] if dram_scales else dram
        rep = en.evaluate_arrays(reads, writes, d, en.ppa_scalars(cfgs[m]))
        rel[m] = {k: v.cpu().numpy()
                  for k, v in en.relative_arrays(base, rep).items()}
    return [IsoResult(p.label,
                      {m: {k: float(rel[m][k][i]) for k in rel[m]}
                       for m in NVM_MEMS})
            for i, p in enumerate(profiles)]


def iso_capacity(profiles: Optional[List[MemoryProfile]] = None,
                 capacity_mb: float = GPU_L2_MB,
                 device: DeviceLike = None) -> List[IsoResult]:
    """Figs 4-5: same capacity, NVM vs SRAM, DRAM identical across mems."""
    dev = resolve_device(device)
    profiles = profiles or paper_profiles(device=dev)
    return _relative_results(profiles,
                             iso_capacity_configs(capacity_mb, dev), dev)


def iso_area(profiles: Optional[List[MemoryProfile]] = None,
             capacity_mb: float = GPU_L2_MB,
             dram_model: str = "analytic",
             trace_kwargs: Optional[Dict] = None,
             device: DeviceLike = None) -> List[IsoResult]:
    """Figs 8-9: same area -> larger NVM caches -> fewer DRAM accesses.

    ``dram_model`` picks how the DRAM-transaction multiplier at the
    iso-area capacities is obtained: ``"analytic"`` uses the power-law
    miss model (core/dram.py); ``"trace"`` runs the batched LRU ladder
    simulator (core/cachesim.py, one launch covering the base capacity
    and both NVM capacities), with ``trace_kwargs`` forwarded to
    ``trace_dram_scale``.
    """
    if dram_model not in ("analytic", "trace"):
        raise ValueError(f"dram_model must be 'analytic' or 'trace', "
                         f"got {dram_model!r}")
    dev = resolve_device(device)
    profiles = profiles or paper_profiles(device=dev)
    cfgs = _configs_iso_area(capacity_mb, dev)
    if dram_model == "trace":
        from repro_torch.core.cachesim import trace_dram_scale
        by_cap = trace_dram_scale(
            [cfgs[m].capacity_mb for m in NVM_MEMS],
            base_mb=capacity_mb, device=dev, **(trace_kwargs or {}))
        scales = {m: by_cap[cfgs[m].capacity_mb] for m in NVM_MEMS}
    else:
        scales = {m: dram_scale(cfgs[m].capacity_mb, capacity_mb)
                  for m in NVM_MEMS}
    return _relative_results(profiles, cfgs, dev, dram_scales=scales)


def iso_area_capacities(capacity_mb: float = GPU_L2_MB,
                        device: DeviceLike = None) -> Dict[str, float]:
    cfgs = _configs_iso_area(capacity_mb, resolve_device(device))
    return {m: cfgs[m].capacity_mb for m in NVM_MEMS}


def summarize(results: List[IsoResult],
              metric: str) -> Dict[str, Dict[str, float]]:
    """avg / best (max reduction = min ratio) per memory for one metric."""
    out = {}
    for m in NVM_MEMS:
        vals = [r.metrics[m][metric] for r in results]
        out[m] = {
            "mean": sum(vals) / len(vals),
            "min": min(vals),                 # best case (max reduction)
            "max": max(vals),
            "mean_reduction_x": len(vals) / sum(vals),  # harmonic-style
            "best_reduction_x": 1.0 / min(vals),
        }
    return out


def batch_sweep(net: str = "AlexNet", mode: str = "training",
                batches=(4, 8, 16, 32, 64, 128),
                device: DeviceLike = None) -> Dict[int, IsoResult]:
    """Fig 6: EDP (with DRAM) vs batch size, iso-capacity: the whole
    batch grid comes from ONE engine evaluation and one energy pass."""
    dev = resolve_device(device)
    cfgs = iso_capacity_configs(GPU_L2_MB, dev)
    tt = tr.compute_traffic(tr.paper_pack(), batches, device=dev)
    profs = [tt.profile(net, mode, b) for b in batches]
    results = _relative_results(profs, cfgs, dev)
    return {b: res for b, res in zip(batches, results)}
