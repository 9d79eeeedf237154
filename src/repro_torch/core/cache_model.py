"""Microarchitecture-level cache PPA model ("NVSim-lite", paper §3.2).

A parametric analytical cache array model (subarray bitline/wordline RC,
decoders, sense amps, H-tree routing with repeaters, bank organization)
whose constants are calibrated so that the EDAP-optimal configurations
reproduce the paper's Table 2 anchors at {SRAM 3MB, STT 3/7MB, SOT 3/10MB}
and the Fig-10 scaling crossovers.

Conventions:
  * reads fill a full 128 B line; writes update one 32 B sector (GPU L2 is
    32 B-sectored) with ~50% bit-flip rate (differential write).
  * "access type" {Normal, Fast, Sequential} is abstracted as a PPA
    trade-off multiplier triple.

The design space swept per (memory, capacity) is banks x subarray-rows x
access type. ``evaluate_batch`` is the array-native core: one elementwise
float32 computation over a stacked (memory x capacity x banks x rows x
access) tensor, differentiable in the calibration constants under
autograd. ``design_grid`` and ``evaluate_config`` are per-point views over
it; ``core.sweep`` builds the batched design-space engine (Algorithm 1,
iso-area search, calibration loss) on top, and ``core.tuner`` keeps the
paper-shaped public API.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import torch

from repro_torch.core.bitcell import TABLE1, Bitcell
from repro_torch.core.constants import LINE_BYTES, MB
from repro_torch.device import DeviceLike, resolve_device

# --- calibrated technology constants (16nm-class) --------------------------
CAL = {
    # frozen calibration fit (mean |log err| 0.088 over the 30 Table-2
    # anchor numbers)
    "sram_cell_um2": 0.107589,   # foundry 6T bitcell (incl. well/strap)
    "layout_overhead": 0.789732,  # array wiring/well overhead multiplier - 1
    "sa_area_um2": 23.0016,      # sense amp + write driver per column
    "bank_area_mm2": 0.0321116,  # per-bank control/decode block
    "dec_ns": 0.17578,           # decoder base delay
    "dec_log_ns": 0.00964161,    # + per log2(rows*banks)
    "bl_ns_per_row": 7.50848e-4,  # bitline RC per row
    "rt_ns_per_mm": 0.748434,    # H-tree (repeatered) delay per mm
    "rt_ns_per_mm2": 0.089795,   # superlinear term (mux/levels)
    "wr_drv_ns": 0.176685,       # write driver setup
    "e_dec_nj": 0.0789971,       # decoder + control energy per access
    "e_wire_nj_mm": 0.193917,    # data movement energy per mm of H-tree
    "e_sense_mult": 10.1942,     # SA + reference path vs raw cell sense
    "wr_flip_rate": 0.213389,    # differential-write bit-flip rate
    "wr_sector_bits": 256,       # 32 B sectored writes (GPU L2)
    "p_cell_nw": 196.726,        # SRAM array leakage per bit (HP 16nm)
    "p_periph_mw_mm2": 942.079,  # periphery leakage per mm^2
}

ACCESS_TYPES = ("Normal", "Fast", "Sequential")
# (latency, energy, area) multipliers
_ACC_MULT = {
    "Normal": (1.00, 1.00, 1.00),
    "Fast": (0.75, 1.25, 1.10),
    "Sequential": (1.10, 0.80, 0.98),
}

BANKS = (1, 2, 4, 8, 16, 32, 64)
ROWS = (128, 256, 512, 1024, 2048)


@dataclasses.dataclass(frozen=True)
class CachePPA:
    """Per-access PPA of one cache configuration."""
    mem: str
    capacity_mb: float
    banks: int
    rows: int
    access_type: str
    read_latency_ns: float
    write_latency_ns: float
    read_energy_nj: float
    write_energy_nj: float
    leakage_mw: float
    area_mm2: float

    @property
    def edap(self) -> float:
        e = 0.5 * (self.read_energy_nj + self.write_energy_nj)
        d = 0.5 * (self.read_latency_ns + self.write_latency_ns)
        return e * d * self.area_mm2

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


PPA_METRICS = ("read_latency_ns", "write_latency_ns", "read_energy_nj",
               "write_energy_nj", "leakage_mw", "area_mm2")

# bitcell fields entering the array model, stacked over the memory axis
_CELL_FIELDS = ("area_rel_sram", "sense_latency_ps", "sense_energy_pj",
                "write_latency_ps", "write_energy_pj", "leak_rel_sram")


def cell_arrays(cells: Sequence[Bitcell],
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Stack bitcell parameters into (M,) float32 tensors for
    ``evaluate_batch``."""
    dev = resolve_device(device)
    return {f: torch.tensor([getattr(c, f) for c in cells],
                            dtype=torch.float32, device=dev)
            for f in _CELL_FIELDS}


def _axis(values, axis: int, device) -> torch.Tensor:
    """``values`` as a float32 tensor laid along ``axis`` of a 5-d grid."""
    shape = [1] * 5
    shape[axis] = len(values)
    return torch.tensor(values, dtype=torch.float32,
                        device=device).reshape(shape)


def evaluate_batch(cells: Dict[str, torch.Tensor], caps_mb,
                   c: Dict = CAL) -> Dict[str, torch.Tensor]:
    """Array-native PPA model: one elementwise computation over the full
    (memory x capacity x banks x rows x access-type) design tensor.

    ``cells`` is a ``cell_arrays`` dict of (M,) tensors, ``caps_mb`` a
    (C,) sequence or tensor of capacities in MB, ``c`` the calibration
    constants (floats, or 0-d tensors that may require grad).  Runs on the
    device of ``cells``.  Returns {metric: (M, C, len(BANKS), len(ROWS),
    len(ACCESS_TYPES))} float32 tensors.
    """
    dev = next(iter(cells.values())).device
    cap = torch.as_tensor(caps_mb, dtype=torch.float32,
                          device=dev).reshape(1, -1, 1, 1, 1)
    cf = {k: v.reshape(-1, 1, 1, 1, 1) for k, v in cells.items()}
    banks = _axis(BANKS, 2, dev)
    rows = _axis(ROWS, 3, dev)
    lat_m = _axis([_ACC_MULT[a][0] for a in ACCESS_TYPES], 4, dev)
    en_m = _axis([_ACC_MULT[a][1] for a in ACCESS_TYPES], 4, dev)
    ar_m = _axis([_ACC_MULT[a][2] for a in ACCESS_TYPES], 4, dev)

    nbits = cap * (MB * 8.0)
    cell_um2 = c["sram_cell_um2"] * cf["area_rel_sram"]
    a_cells = nbits * cell_um2 * 1e-6 * (1.0 + c["layout_overhead"])  # mm^2
    n_cols = nbits / rows
    a_periph = n_cols * c["sa_area_um2"] * 1e-6 / torch.sqrt(banks) \
        + banks * c["bank_area_mm2"]
    area = (a_cells + a_periph) * ar_m

    line_bits = LINE_BYTES * 8.0
    dist_mm = torch.sqrt(area / banks) + 0.5 * torch.sqrt(area)
    t_dec = c["dec_ns"] + c["dec_log_ns"] * torch.log2(rows * banks)
    t_bl = c["bl_ns_per_row"] * rows
    t_rt = c["rt_ns_per_mm"] * dist_mm + c["rt_ns_per_mm2"] * area
    t_read = (t_dec + t_bl + cf["sense_latency_ps"] * 1e-3 + t_rt) * lat_m
    t_write = (t_dec + 0.5 * t_rt + c["wr_drv_ns"]
               + cf["write_latency_ps"] * 1e-3) * lat_m

    e_wire = c["e_wire_nj_mm"] * dist_mm
    e_read = (c["e_dec_nj"] + e_wire
              + line_bits * cf["sense_energy_pj"] * 1e-3
              * c["e_sense_mult"]) * en_m
    e_write = (c["e_dec_nj"] + e_wire
               + c["wr_sector_bits"] * c["wr_flip_rate"]
               * cf["write_energy_pj"] * 1e-3) * en_m

    leak = (c["p_cell_nw"] * 1e-6 * nbits * cf["leak_rel_sram"]
            + c["p_periph_mw_mm2"] * (area - a_cells * ar_m
                                      + 0.08 * a_cells * ar_m))
    shape = torch.broadcast_shapes(area.shape, lat_m.shape, en_m.shape)
    return {
        "read_latency_ns": t_read.expand(shape),
        "write_latency_ns": t_write.expand(shape),
        "read_energy_nj": e_read.expand(shape),
        "write_energy_nj": e_write.expand(shape),
        "leakage_mw": leak.expand(shape),
        "area_mm2": area.expand(shape),
    }


def cal_tensors(c: Dict, device: DeviceLike = None
                ) -> Dict[str, torch.Tensor]:
    """Calibration constants as 0-d float32 tensors, so that every term of
    ``evaluate_batch`` is computed in float32 as the reference does."""
    dev = resolve_device(device)
    return {k: torch.tensor(float(v), dtype=torch.float32, device=dev)
            for k, v in c.items()}


def _evaluate_grid(cell: Bitcell, capacity_mb: float, c: Dict,
                   device: DeviceLike):
    """Per-point view over ``evaluate_batch``: PPA dict of numpy arrays
    shaped (len(BANKS), len(ROWS), len(ACCESS_TYPES))."""
    g = evaluate_batch(cell_arrays([cell], device), [capacity_mb],
                       cal_tensors(c, device))
    return {k: v[0, 0].cpu().numpy() for k, v in g.items()}


def evaluate_config(mem: str, capacity_mb: float, banks: int, rows: int,
                    access_type: str, cal: Dict = CAL,
                    device: DeviceLike = None) -> CachePPA:
    g = _evaluate_grid(TABLE1[mem], capacity_mb, cal, device)
    bi, ri = BANKS.index(banks), ROWS.index(rows)
    ai = ACCESS_TYPES.index(access_type)
    vals = {k: float(v[bi, ri, ai]) for k, v in g.items()}
    return CachePPA(mem=mem, capacity_mb=capacity_mb, banks=banks, rows=rows,
                    access_type=access_type, **vals)


def design_grid(mem: str, capacity_mb: float, cal: Dict = CAL,
                device: DeviceLike = None):
    """All CachePPA points of the design space for (mem, capacity)."""
    full = _evaluate_grid(TABLE1[mem], capacity_mb, cal, device)
    out = []
    for bi, b in enumerate(BANKS):
        for ri, r in enumerate(ROWS):
            for ai, a in enumerate(ACCESS_TYPES):
                out.append(CachePPA(
                    mem=mem, capacity_mb=capacity_mb, banks=b, rows=r,
                    access_type=a,
                    **{k: float(v[bi, ri, ai]) for k, v in full.items()}))
    return out
