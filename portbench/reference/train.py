"""The first steps of training worked out again in float32: the loss of
each step, each weight's first gradient as the optimizer gets it (after
the global-norm clip) and each weight's change after the steps.

AdamW as the configuration states it: float32 master weights, the
forward on the master rounded to the bf16 the weights are stored in,
gradients averaged over the microbatches (row chunks of the batch), one
global-norm clip at 1.0, b1 0.9, b2 0.95, eps 1e-8, decoupled weight decay
0.1 on every weight, bias-corrected moments, and the warmup-cosine
learning rate (base x step / warmup before ``warmup`` steps, then a cosine
from base to base x 0.1 over the rest of ``total``)."""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference import data
from portbench.reference.decoder import train_loss
from portbench.reference.numerics import Numerics


def lr_at(recipe: dict, step: int) -> float:
    """The learning rate of optimizer step ``step`` (1-based)."""
    base, warm, total = recipe["lr"], recipe["warmup"], recipe["total"]
    if step < warm:
        return base * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return base * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


def run(arch: dict, W0: Dict[str, torch.Tensor], recipe: dict, seed: int,
        steps: int, num: Numerics = None, rows=None,
        param_dtype: torch.dtype = torch.bfloat16) -> dict:
    """``steps`` training steps from the weights ``W0`` (as made, bf16) on
    the rows the port's window hashes for ``seed``.  ``rows`` (a slice)
    keeps only those rows of each step's batch (a planted fault: part of
    the batch left out).  ``param_dtype`` is the type the weights are
    stored in (the forward reads the master weights rounded to it).
    Returns {"loss": [per step], "grad": {name:
    norm of the first clipped gradient}, "change": {name: norm of the
    master weights' change after the steps}}."""
    num = num or Numerics()
    names = sorted(W0)
    master = {n: W0[n].float().clone() for n in names}
    m = {n: torch.zeros_like(master[n]) for n in names}
    v = {n: torch.zeros_like(master[n]) for n in names}
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1
    losses: List[float] = []
    first_grad = {}
    dev = next(iter(W0.values())).device
    for step in range(steps):
        tokens, labels = data.batch(seed, step, recipe["batch"],
                                    recipe["seq"], arch["V"], dev)
        if rows is not None:
            tokens, labels = tokens[rows], labels[rows]
        chunks = recipe["microbatches"]
        n_rows = tokens.shape[0] // chunks
        W = {n: master[n].to(param_dtype).to(torch.float32, copy=True)
             .requires_grad_()
             for n in names}
        grads = {n: torch.zeros_like(master[n]) for n in names}
        total = 0.0
        for c in range(chunks):
            sl = slice(c * n_rows, (c + 1) * n_rows)
            loss = train_loss(arch, num, W, tokens[sl], labels[sl])
            g = torch.autograd.grad(loss, [W[n] for n in names],
                                    allow_unused=True)
            for n, gi in zip(names, g):
                if gi is not None:
                    grads[n] += gi
            total += float(loss.detach())
            del g, loss
        del W
        for n in names:
            grads[n] /= chunks
        losses.append(total / chunks)
        gnorm = math.sqrt(sum(float(torch.sum(grads[n] * grads[n]))
                              for n in names))
        scale = min(1.0, 1.0 / max(gnorm, 1e-9))
        t = step + 1
        lr = lr_at(recipe, t)
        for n in names:
            g = grads[n] * scale
            if step == 0:
                first_grad[n] = float(torch.linalg.vector_norm(g))
            m[n].mul_(b1).add_((1 - b1) * g)
            v[n].mul_(b2).add_((1 - b2) * g * g)
            upd = (m[n] / (1 - b1 ** t)) / (torch.sqrt(v[n] / (1 - b2 ** t))
                                           + eps)
            master[n].sub_(lr * (upd + wd * master[n]))
        del grads
    change = {n: float(torch.linalg.vector_norm(master[n] - W0[n].float()))
              for n in names}
    return {"loss": losses, "grad": first_grad, "change": change}
