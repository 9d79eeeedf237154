"""The calibration tools (torch counterparts of ``tools/``), run as
modules:

    PYTHONPATH=src python -m repro_torch.tools.calibrate_cache [--steps N]
    PYTHONPATH=src python -m repro_torch.tools.calibrate_traffic [--steps N]

Both fit log-space constants by Adam over a loss that autograd
differentiates, through ``adam_fit`` below, and run on the CUDA device
unless given ``--device cpu``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.optim import AdamW, constant

Params = Dict[str, torch.Tensor]


def clip_log(params: Params, bounds: Dict[str, Tuple[float, float]]) -> None:
    """Clamp each bounded log-space parameter to [log lo, log hi], in
    place (the JAX tools' ``_clip``)."""
    for k, (lo, hi) in bounds.items():
        params[k].clamp_(math.log(lo), math.log(hi))


def adam_fit(loss_of: Callable[[Params], torch.Tensor], params: Params,
             steps: int, lr: float,
             bounds: Dict[str, Tuple[float, float]],
             log: Optional[Callable[[str], None]] = print,
             start: str = "") -> Tuple[Params, float, List[float]]:
    """The JAX tools' loop: ``AdamW(lr=constant(lr), weight_decay=0.0,
    clip_norm=1.0, master_weights=False)`` over ``params`` (0-d float32
    tensors, updated in place), each step's gradient by reverse-mode
    autograd of ``loss_of``, the bounds clamped after each update.

    The best-seen iterate is kept in the JAX order: a step's loss is read
    before its update, and the final iterate is compared last; so the
    result is never worse than the start.  Returns ``(best, best_loss,
    history)``, ``history`` the loss of every iterate in turn (the start
    first, the final iterate last: ``steps + 1`` values), so that the
    best step is ``history.index(best_loss)``.  ``log`` takes the start
    loss (``start`` appended) and every 50th step's."""
    opt = AdamW(lr=constant(lr), weight_decay=0.0, clip_norm=1.0,
                master_weights=False)
    state = opt.init(params)
    best, best_loss, history = None, float("inf"), []
    for it in range(steps):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = loss_of(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        history.append(float(loss.detach()))
        if log is not None and it == 0:
            log(f"start loss {history[0]:.4f}{start}")
        if history[-1] < best_loss:
            best = {k: v.clone() for k, v in params.items()}
            best_loss = history[-1]
        opt.update(dict(zip(leaves, grads)), state, params)
        clip_log(params, bounds)
        if log is not None and it % 50 == 49:
            log(f"iter {it + 1}: loss {history[-1]:.4f} "
                f"(best {best_loss:.4f})")
    with torch.no_grad():
        history.append(float(loss_of(params)))
    if history[-1] < best_loss:
        best = {k: v.clone() for k, v in params.items()}
        best_loss = history[-1]
    return best, best_loss, history
