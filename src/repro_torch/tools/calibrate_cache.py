"""Calibrate the NVSim-lite constants against the paper's Table 2 anchors
(torch counterpart of ``tools/calibrate_cache.py``).

The loss, the weighted mean |log(pred/target)| over the 30 Table-2
numbers at the EDAP-tuned configurations, is
``core.sweep.make_calibration_loss``: one differentiable batched sweep
(the Algorithm-1 selection is piecewise constant and detached).  Adam on
the log of each tunable constant, gradients by autograd, physical bounds
clamped after each step, the best-seen iterate kept (``tools.adam_fit``).

    PYTHONPATH=src python -m repro_torch.tools.calibrate_cache \
        [--steps N] [--lr LR] [--device cpu]

Prints the best CAL dict (the winner is frozen into
``core/cache_model.py``) and each anchor's tuned value beside its target.
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.core.cache_model import CAL
from repro_torch.core.sweep import make_calibration_loss
from repro_torch.core.table2 import TABLE2_ANCHORS
from repro_torch.core.tuner import tune
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tools import adam_fit

FIELDS = dict(rl="read_latency_ns", wl="write_latency_ns",
              re="read_energy_nj", we="write_energy_nj",
              lk="leakage_mw", ar="area_mm2")

TARGETS = {key: {s: row[f] for s, f in FIELDS.items()}
           for key, row in TABLE2_ANCHORS.items()}

# read/write energies drive the paper's dynamic-energy ratios (Fig 4), so
# they get extra weight; area anchors the iso-area capacities.
WEIGHTS = dict(rl=1.2, wl=1.0, re=3.0, we=2.0, lk=1.0, ar=1.5)

TUNABLE = [k for k in CAL if k not in ("wr_sector_bits",)]

# physical bounds, enforced by clipping after each step (log-space params)
BOUNDS = {"wr_flip_rate": (0.2, 1.0), "sram_cell_um2": (0.05, 0.12)}


def _to_cal(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    cal = {k: torch.exp(v) for k, v in params.items()}
    v = next(iter(params.values()))
    cal["wr_sector_bits"] = torch.tensor(float(CAL["wr_sector_bits"]),
                                         dtype=torch.float32, device=v.device)
    return cal


def calibrate(steps: int = 300, lr: float = 0.02, device: DeviceLike = None,
              log=print) -> Tuple[Dict[str, float], float, List[float]]:
    """Fit ``TUNABLE`` from the frozen CAL.  Returns ``(best CAL as floats,
    best loss, history)``, ``history`` as ``tools.adam_fit`` gives it."""
    dev = resolve_device(device)
    anchor_loss = make_calibration_loss(TARGETS, WEIGHTS, FIELDS, dev)
    params = {k: torch.tensor(math.log(CAL[k]), dtype=torch.float32,
                              device=dev) for k in TUNABLE}
    best, best_loss, history = adam_fit(
        lambda p: anchor_loss(_to_cal(p)), params, steps, lr, BOUNDS,
        log=log)
    return ({k: float(v) for k, v in _to_cal(best).items()}, best_loss,
            history)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cal, best_loss, history = calibrate(args.steps, args.lr, dev)
    print("\nCAL = {")
    for k in CAL:
        print(f"    {k!r}: {cal[k]:.6g},")
    print("}")
    print(f"\nfinal loss {best_loss:.4f} (best step "
          f"{history.index(best_loss)} of {args.steps})")
    for (mem, cap), tgt in TARGETS.items():
        p = tune(mem, cap, cal, dev)
        row = "  ".join(f"{k}={getattr(p, f):8.2f}/{tgt[k]:8.2f}"
                        for k, f in FIELDS.items())
        print(f"{mem:5s}{cap:3d}MB {row}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
