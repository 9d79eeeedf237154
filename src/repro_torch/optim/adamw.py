"""AdamW with f32 master weights and global-norm clipping (torch
counterpart of ``repro/optim/adamw.py``, in its operation order).

State is ``{"m", "v", "count", "master"}``: m, v and master are dicts keyed
like the parameters, f32; count is a 0-d int32 tensor.  The state carries
the parameters' logical axes (``state_axes``), so FSDP sharding extends to
m, v and master.  ``update`` works IN
PLACE on the parameters and the state (the JAX version returns new trees):
at llama3-8b's width the state is several times the weights, and a second
copy would not fit on one card.  Every quantity stays a device tensor (the
clip scale, the bias corrections from ``count``, the learning rate), so an
update never waits on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    master_weights: bool = True

    def init(self, params: Tensors) -> Dict:
        def zeros32(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        device = next(iter(params.values())).device
        state = {"m": {n: zeros32(p) for n, p in params.items()},
                 "v": {n: zeros32(p) for n, p in params.items()},
                 "count": torch.zeros((), dtype=torch.int32, device=device)}
        if self.master_weights:
            # a copy even for f32 params: master and params are updated
            # separately in place
            state["master"] = {n: p.to(torch.float32, copy=True)
                               for n, p in params.items()}
        return state

    def abstract_state(self, params: Tensors) -> Dict:
        """``init``'s structure as ``meta`` stand-ins (nothing allocated):
        f32 m, v (and master) like each parameter, an int32 0-d count."""
        def f32(p):
            return torch.empty(p.shape, dtype=torch.float32, device="meta")

        state = {"m": {n: f32(p) for n, p in params.items()},
                 "v": {n: f32(p) for n, p in params.items()},
                 "count": torch.empty((), dtype=torch.int32, device="meta")}
        if self.master_weights:
            state["master"] = {n: f32(p) for n, p in params.items()}
        return state

    def state_axes(self, param_axes: Dict) -> Dict:
        """The state's logical axes: the moments (and master) carry their
        parameter's, so FSDP sharding extends to them."""
        state = {"m": param_axes, "v": param_axes, "count": ()}
        if self.master_weights:
            state["master"] = param_axes
        return state

    @torch.no_grad()
    def update(self, grads: Tensors, state: Dict,
               params: Tensors) -> Dict[str, torch.Tensor]:
        """One step: clip by global norm, advance count, update m, v, the
        master weights and the parameters in place.  Returns
        ``{"grad_norm", "lr"}`` as 0-d device tensors."""
        names = sorted(params)
        g = {n: grads[n].to(torch.float32) for n in names}
        gnorm = global_norm(g)
        if self.clip_norm:
            scale = torch.clamp(
                self.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
            g = {n: g[n] * scale for n in names}

        count = state["count"]
        count += 1
        lr = self.lr(count)
        b1c = 1 - self.b1 ** count.to(torch.float32)
        b2c = 1 - self.b2 ** count.to(torch.float32)
        for n in names:
            m, v = state["m"][n], state["v"][n]
            m.mul_(self.b1).add_((1 - self.b1) * g[n])
            v.mul_(self.b2).add_((1 - self.b2) * g[n] * g[n])
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            if self.master_weights:
                base = state["master"][n]
                base.sub_(lr * (upd + self.weight_decay * base))
                params[n].copy_(base)
            else:
                base = params[n].to(torch.float32)
                params[n].copy_(base - lr * (upd + self.weight_decay * base))
        return {"grad_norm": gnorm, "lr": lr}


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted by name) of each leaf's f32 sum
    of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[n].to(torch.float32)))
                          for n in sorted(tree)))
