"""Batched design-space sweep engine.

One call evaluates the full PPA tensor over
(memory x capacity x banks x rows x access-type) on the device and runs the
paper's Algorithm 1 as a masked argmin over the grid axes: no Python loops,
no per-point ``CachePPA`` materialization.  This is the engine behind
``core.tuner`` (which keeps the paper-shaped public API), the iso-capacity
and iso-area analyses, the scalability sweeps, and the differentiable
Table-2 calibration loss.

Layout conventions (fixed throughout):

    axis 0  M  memory technology        (order of ``mems``)
    axis 1  C  capacity in MB           (order of ``capacities_mb``)
    axis 2  B  bank count               (``cache_model.BANKS``)
    axis 3  R  subarray rows            (``cache_model.ROWS``)
    axis 4  A  access type              (``cache_model.ACCESS_TYPES``)

Algorithm 1 (tuning): for each optimization target in ``OPT_TARGETS``
crossed with each access type, the per-(B, R) argmin is a candidate; the
candidate minimizing EDAP wins.  Ties resolve to the first candidate in
(target-major, access-minor) order and the first (bank-major) grid point
(``torch.argmin`` returns the first minimum), the iteration order of the
per-point loop in ``tuner.tune_reference``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bitcell import TABLE1
from repro_torch.core.cache_model import (ACCESS_TYPES, BANKS, CAL, CachePPA,
                                          PPA_METRICS, ROWS, cal_tensors,
                                          cell_arrays, evaluate_batch)
from repro_torch.device import DeviceLike, resolve_device

# Algorithm 1's objective set O (paper §3.2); order = per-point loop order.
OPT_TARGETS = (
    "read_latency", "write_latency", "read_energy", "write_energy",
    "read_edp", "write_edp", "area", "leakage",
)


def _edap(grid: Dict[str, torch.Tensor]) -> torch.Tensor:
    e = 0.5 * (grid["read_energy_nj"] + grid["write_energy_nj"])
    d = 0.5 * (grid["read_latency_ns"] + grid["write_latency_ns"])
    return e * d * grid["area_mm2"]


def _objectives(grid: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stack the Algorithm-1 objective tensors: (O, M, C, B, R, A)."""
    return torch.stack([
        grid["read_latency_ns"],
        grid["write_latency_ns"],
        grid["read_energy_nj"],
        grid["write_energy_nj"],
        grid["read_energy_nj"] * grid["read_latency_ns"],
        grid["write_energy_nj"] * grid["write_latency_ns"],
        grid["area_mm2"],
        grid["leakage_mw"],
    ])


def _algorithm1(grid: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Masked-argmin Algorithm 1 over the grid axes.

    Returns (M, C) int32 flat indices into the (B, R, A) design space.
    """
    edap = _edap(grid)
    objs = _objectives(grid)
    o, m, c, b, r, a = objs.shape
    # line 9-10: per (target, access) candidate = argmin over (banks, rows)
    cand_br = torch.argmin(objs.reshape(o, m, c, b * r, a), dim=3)  # (O,M,C,A)
    edap_flat = edap.reshape(m, c, b * r, a)
    cand_edap = torch.take_along_dim(
        edap_flat[None], cand_br[:, :, :, None, :], dim=3)[:, :, :, 0, :]
    # lines 11-13: EDAP-best candidate, first win on ties in
    # (target-major, access-minor) iteration order
    cand_br = cand_br.movedim(0, 2).reshape(m, c, o * a)
    cand_edap = cand_edap.movedim(0, 2).reshape(m, c, o * a)
    win = torch.argmin(cand_edap, dim=2)                           # (M, C)
    br = torch.take_along_dim(cand_br, win[:, :, None], dim=2)[:, :, 0]
    return (br * a + win % a).to(torch.int32)


def _gather(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, C, B, R, A) metric at the (M, C) flat design indices."""
    m, c = idx.shape
    return torch.take_along_dim(v.reshape(m, c, -1), idx[:, :, None].long(),
                                dim=2)[:, :, 0]


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Full PPA tensor + Algorithm-1 selections for one batched sweep.

    ``grid`` maps each metric (plus ``edap``) to an (M, C, B, R, A) array;
    ``tuned`` holds the same metrics gathered at the selected design point,
    shaped (M, C); ``sel`` is the (M, C) flat index into (B, R, A).
    """
    mems: Tuple[str, ...]
    capacities_mb: Tuple[float, ...]
    grid: Dict[str, np.ndarray]
    sel: np.ndarray
    tuned: Dict[str, np.ndarray]

    def _loc(self, mem: str, capacity_mb: float) -> Tuple[int, int]:
        if mem not in self.mems:
            raise ValueError(f"{mem!r} not in this sweep (has {self.mems})")
        if float(capacity_mb) not in self.capacities_mb:
            raise ValueError(f"{capacity_mb} MB not in this sweep (has "
                             f"{self.capacities_mb})")
        return self.mems.index(mem), self.capacities_mb.index(
            float(capacity_mb))

    def selection(self, mem: str, capacity_mb: float) -> Tuple[int, int, str]:
        """Selected (banks, rows, access_type) for one (mem, capacity)."""
        mi, ci = self._loc(mem, capacity_mb)
        bi, ri, ai = np.unravel_index(
            self.sel[mi, ci], (len(BANKS), len(ROWS), len(ACCESS_TYPES)))
        return BANKS[bi], ROWS[ri], ACCESS_TYPES[ai]

    def config(self, mem: str, capacity_mb: float) -> CachePPA:
        """EDAP-tuned ``CachePPA`` view of one (mem, capacity) cell."""
        mi, ci = self._loc(mem, capacity_mb)
        banks, rows, acc = self.selection(mem, capacity_mb)
        vals = {k: float(self.tuned[k][mi, ci]) for k in PPA_METRICS}
        return CachePPA(mem=mem, capacity_mb=float(capacity_mb), banks=banks,
                        rows=rows, access_type=acc, **vals)

    def configs(self) -> Dict[str, Dict[float, CachePPA]]:
        """{mem: {capacity: CachePPA}} over the whole sweep."""
        return {m: {c: self.config(m, c) for c in self.capacities_mb}
                for m in self.mems}


def sweep(mems: Sequence[str], capacities_mb: Sequence[float],
          cal: Optional[Dict] = None,
          device: DeviceLike = None) -> SweepResult:
    """Evaluate + tune the full (mems x capacities) design space in one
    batched call on ``device``.  ``cal`` defaults to the frozen
    calibration constants."""
    dev = resolve_device(device)
    mems = tuple(mems)
    caps = tuple(float(c) for c in capacities_mb)
    cells = cell_arrays([TABLE1[m] for m in mems], dev)
    grid = evaluate_batch(cells, caps, cal_tensors(cal or CAL, dev))
    grid["edap"] = _edap(grid)
    idx = _algorithm1(grid)
    tuned = {k: _gather(v, idx) for k, v in grid.items()}
    return SweepResult(
        mems=mems, capacities_mb=caps,
        grid={k: v.cpu().numpy() for k, v in grid.items()},
        sel=idx.cpu().numpy(),
        tuned={k: v.cpu().numpy() for k, v in tuned.items()},
    )


# --- iso-area capacity search ----------------------------------------------


def capacity_ladder(start_mb: float = 0.5, max_mb: float = 64.0,
                    steps_per_octave: int = 2,
                    include: Sequence[float] = ()) -> Tuple[float, ...]:
    """Geometric capacity ladder; the default is the half-octave search
    (0.5 MB .. 64 MB in x sqrt(2) steps).

    ``include`` splices extra capacities into the rung sequence (sorted,
    deduplicated), e.g. the 3 MB GPU-L2 baseline, so the trace-driven
    ladder simulation (``core.cachesim.simulate_ladder``) covers both the
    iso-area search rungs and the normalization point in one batch.
    """
    caps = []
    k = 0
    while True:
        # direct exponentiation, not repeated multiplication: accumulated
        # error would make 0.5 * sqrt(2)^14 > 64 and drop the top rung
        # (whole-octave rungs are exactly round: 2.0 ** (k / steps))
        cap = start_mb * 2.0 ** (k / steps_per_octave)
        if cap > max_mb and not math.isclose(cap, max_mb, rel_tol=1e-9):
            break
        caps.append(cap)
        k += 1
    for extra in include:
        # half-octave rungs are inexact, so exact membership would
        # duplicate whole-number includes like 2.0
        if not any(math.isclose(float(extra), c, rel_tol=1e-9)
                   for c in caps):
            caps.append(float(extra))
    return tuple(sorted(caps))


def iso_area_search(mems: Sequence[str], area_budget_mm2: float,
                    tol: float = 0.08,
                    ladder: Optional[Sequence[float]] = None,
                    device: DeviceLike = None) -> Dict[str, CachePPA]:
    """Largest capacity per memory whose EDAP-tuned area fits the budget.

    One batched sweep over the whole (mems x ladder) grid.  Raises
    ``ValueError`` when no ladder capacity fits for some memory.
    """
    ladder = tuple(ladder if ladder is not None else capacity_ladder())
    s = sweep(mems, ladder, device=device)
    fits = s.tuned["area_mm2"] <= area_budget_mm2 * (1.0 + tol)  # (M, C)
    out = {}
    for mi, mem in enumerate(s.mems):
        fitting = np.flatnonzero(fits[mi])
        if fitting.size == 0:
            raise ValueError(
                f"iso-area search: no {mem} capacity in "
                f"[{ladder[0]:g}, {ladder[-1]:g}] MB fits the area budget "
                f"{area_budget_mm2:.3f} mm^2 (tol {tol:.0%}); smallest tuned "
                f"area is {float(s.tuned['area_mm2'][mi].min()):.3f} mm^2")
        out[mem] = s.config(mem, s.capacities_mb[int(fitting[-1])])
    return out


# --- differentiable Table-2 calibration ------------------------------------


def make_calibration_loss(targets: Dict[Tuple[str, float], Dict[str, float]],
                          weights: Dict[str, float],
                          field_map: Dict[str, str],
                          device: DeviceLike = None):
    """Build a loss over the sweep engine that autograd differentiates.

    ``targets`` maps (mem, capacity_mb) -> {short_key: target_value} (the
    Table-2 anchors); ``weights`` maps short_key -> weight; ``field_map``
    maps short_key -> PPA metric name.  The returned ``loss(cal)`` takes a
    dict of 0-d float32 tensors (``cache_model.cal_tensors``) and returns
    the weighted mean |log(pred / target)| over all anchor numbers, where
    pred comes from the Algorithm-1-tuned configuration: the argmin
    selection is piecewise constant in ``cal`` and detached, so gradients
    flow through the selected design point.
    """
    dev = resolve_device(device)
    mems = tuple(dict.fromkeys(m for m, _ in targets))
    caps = tuple(dict.fromkeys(float(c) for _, c in targets))
    cells = cell_arrays([TABLE1[m] for m in mems], dev)

    mi, ci, fi, tgt, wgt = [], [], [], [], []
    fields = tuple(field_map.values())
    for (mem, cap), row in targets.items():
        for key, value in row.items():
            mi.append(mems.index(mem))
            ci.append(caps.index(float(cap)))
            fi.append(fields.index(field_map[key]))
            tgt.append(value)
            wgt.append(weights[key])
    mi, ci, fi = (torch.tensor(x, device=dev) for x in (mi, ci, fi))
    tgt = torch.tensor(tgt, dtype=torch.float32, device=dev)
    wgt = torch.tensor(wgt, dtype=torch.float32, device=dev)

    def loss(cal: Dict) -> torch.Tensor:
        grid = evaluate_batch(cells, caps, cal)
        idx = _algorithm1({k: v.detach() for k, v in grid.items()})
        tuned = torch.stack([_gather(grid[f], idx)
                             for f in fields])                 # (F, M, C)
        pred = tuned[fi, mi, ci]
        return torch.sum(wgt * torch.abs(torch.log(pred / tgt))) / len(mi)

    return loss
