"""Calibrate the workload traffic model against the paper's §4 claims
(torch counterpart of ``tools/calibrate_traffic.py``).

Adam over the differentiable claim loss ``core.traffic.make_claim_loss``
(the traffic -> PPA -> energy/EDP pipeline as one function of the six
TRAFFIC knobs), knobs in log space, physical bounds clamped after each
step, the best-seen iterate kept (``tools.adam_fit``).  It starts at the
frozen TRAFFIC, so the start is the first iterate seen and the result is
never worse than the frozen fit.

The gradient it follows is reverse-mode autograd of ``make_claim_loss``,
which ``tests/test_torch_nvm.py::test_claim_loss_and_grad_match_jax``
holds to ``jax.jacfwd`` of the JAX loss, and to its central differences
where ``jacfwd`` is NaN (the two DRAM fractions).  The JAX tool follows
``jax.grad``, which differs from both on five of the six knobs, so the
two tools' trajectories are not expected to agree.

    PYTHONPATH=src python -m repro_torch.tools.calibrate_traffic \
        [--steps N] [--lr LR] [--device cpu]

Prints the best TRAFFIC dict (the winner is frozen into
``core/traffic.py``), the claims beside their targets, and the R/W ratios.
"""
from __future__ import annotations

import argparse
import math
from typing import Dict, List, Tuple

import torch

from repro_torch.core.traffic import (TRAFFIC, compute_traffic,
                                      make_claim_loss, paper_pack)
from repro_torch.core.workloads import HPCG, NETWORKS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.tools import adam_fit

KNOBS = ("k_im2col", "w_tile", "grad_tile", "fc_w_factor",
         "dram_frac_i", "dram_frac_t")

# physical bounds, enforced by clipping after each step (log-space params)
BOUNDS = {
    "k_im2col": (0.1, 2.0),       # net im2col amplification vs L1 reuse
    "w_tile": (1.0, 1e4),         # >= one sample per weight re-stream
    "grad_tile": (0.5, 1e3),
    "fc_w_factor": (0.02, 1.0),   # coalescing can only reduce streams
    "dram_frac_i": (1e-4, 0.2),   # DRAM:L2 ratios stay cache-hit-dominated
    "dram_frac_t": (1e-4, 0.2),
}


def calibrate(steps: int = 300, lr: float = 0.02, device: DeviceLike = None,
              log=print) -> Tuple[Dict[str, float], float, List[float]]:
    """Fit the six knobs from the frozen TRAFFIC.  Returns ``(best knobs
    as floats, best loss, history)``, ``history`` as ``tools.adam_fit``
    gives it (``history[0]`` is the frozen TRAFFIC's loss)."""
    dev = resolve_device(device)
    claim_loss, _ = make_claim_loss(device=dev)
    params = {k: torch.tensor(math.log(TRAFFIC[k]), dtype=torch.float32,
                              device=dev) for k in KNOBS}
    best, best_loss, history = adam_fit(
        lambda p: claim_loss({k: torch.exp(v) for k, v in p.items()}),
        params, steps, lr, BOUNDS, log=log, start=" (frozen TRAFFIC)")
    return ({k: float(torch.exp(v)) for k, v in best.items()}, best_loss,
            history)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Adam over the claim loss, following the reverse-mode "
                    "autograd gradient of make_claim_loss (held to "
                    "jax.jacfwd and central differences; the JAX tool "
                    "follows jax.grad, which differs on five of six "
                    "knobs, so the two trajectories differ)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t, best_loss, history = calibrate(args.steps, args.lr, dev)
    print("\nTRAFFIC = {")
    for k in KNOBS:
        print(f"    {k!r}: {t[k]:.6g},")
    print("}")
    _, claims_fn = make_claim_loss(device=dev)
    claims, pen = claims_fn(t)
    print(f"final loss {best_loss:.4f}  range-penalty {pen:.3f} (best step "
          f"{history.index(best_loss)} of {args.steps})")
    for k, (p, tgt) in claims.items():
        print(f"  {k:14s} pred={p:7.2f} target={tgt:7.2f}")
    tt = compute_traffic(paper_pack(), (4.0, 64.0), t, dev)
    rw = {}
    for n in NETWORKS:
        rw[f"{n}-I"] = round(tt.profile(n, "inference", 4).rw_ratio, 1)
        rw[f"{n}-T"] = round(tt.profile(n, "training", 64).rw_ratio, 1)
    for n in HPCG:
        rw[n] = round(tt.profile(n, "hpc", 1).rw_ratio, 1)
    print("R/W:", rw)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
