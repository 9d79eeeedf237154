"""Train step and the fused K-step train window (torch counterpart of
``repro/train/trainer.py`` for one device).

``make_train_step(model, opt)(state, batch)`` is the per-step oracle: loss
-> grads -> AdamW, with gradient accumulation over ``microbatches`` row
chunks of the batch.  ``TrainWindow`` runs ``steps_per_sync`` (K) of those
steps, each on a batch hashed on the card from ``state["step"]``
(``device_batch_at``, the bitwise twin of the host ``Pipeline``), and
returns the stacked (K,) loss, grad_norm and lr as device tensors: nothing
inside a window waits on the card, and the caller's one read of the
stacked metrics is the window's only host sync.  Given the same tokens the
window and the per-step loop run the same operations, so their
trajectories agree bit for bit (on the card under deterministic
algorithms, which the embedding gradient's atomics need).

A train state is ``{"params", "opt", "step"}``: the flat parameter dict,
the AdamW state and a 0-d int32 step on the model's device.  Steps update
it IN PLACE (parameters, optimizer state and step) and return it: at full
width a second copy would not fit on the card.  Copy a state before a step
to keep it.

Not ported yet: EF-int8 gradient compression (``compress_grads=True``
raises), and the window's traffic records and NVM verdicts
(``train_records`` / ``nvm_verdicts``), which need the roofline walker and
``core/crosslayer.py``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.data.pipeline import DataConfig, device_batch_at
from repro_torch.models.api import Model
from repro_torch.models.common import Params
from repro_torch.optim.adamw import AdamW

TrainState = Dict[str, Any]  # {"params", "opt", "step"}


def _refuse_compression(compress_grads: bool) -> None:
    if compress_grads:
        raise NotImplementedError(
            "compress_grads=True (EF-int8 gradient compression, "
            "optim/compress.py) is not ported yet; it comes in a later "
            "slice of the port")


def init_state(model: Model, opt: AdamW,
               generator: torch.Generator) -> TrainState:
    """Weights drawn from ``generator`` by the model's init rules, a fresh
    optimizer state and step 0, on the model's device."""
    params = model.init(generator)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model.device)}


def clone_state(state: TrainState) -> TrainState:
    """A deep copy of a train state (steps update theirs in place)."""
    if isinstance(state, dict):
        return {k: clone_state(v) for k, v in state.items()}
    return state.clone()


def window_boundary_crossed(step: int, window: int, every: int) -> bool:
    """True when the window that just ended at ``step`` (i.e. covered
    steps ``step - window .. step``) crossed a multiple of ``every`` —
    the checkpoint cadence of launch/train.py."""
    return (step // every) > ((step - window) // every)


def _split_leading(x: torch.Tensor, n: int) -> torch.Tensor:
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def make_train_step(model: Model, opt: AdamW, *, microbatches: int = 1,
                    compress_grads: bool = False,
                    attn_impl: str = "kernel") -> Callable:
    """The train step ``(state, batch) -> (state, metrics)``; ``batch``
    holds (B, S) ``tokens`` and ``labels`` on the model's device, B a
    multiple of ``microbatches``.  Metrics are 0-d device tensors
    ``loss``, ``grad_norm`` and ``lr``.  Updates ``state`` in place."""
    if microbatches < 1:
        raise ValueError("microbatches must be >= 1")
    _refuse_compression(compress_grads)
    names = sorted(model.param_defs)

    def value_and_grad(params: Params, batch):
        leaves = {n: params[n].detach().requires_grad_() for n in names}
        loss = model.loss(leaves, batch, attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names])
        return loss.detach(), dict(zip(names, grads))

    def local_grads(params: Params, batch):
        """(mean loss, mean grads) over ``microbatches`` chunks of batch;
        with chunks the gradients accumulate in f32, as in JAX."""
        if microbatches == 1:
            return value_and_grad(params, batch)
        micro = {k: _split_leading(x, microbatches) for k, x in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        grads = {n: torch.zeros(params[n].shape, dtype=torch.float32,
                                device=model.device) for n in names}
        for i in range(microbatches):
            l, g = value_and_grad(params, {k: x[i] for k, x in micro.items()})
            loss = loss + l
            for n in names:
                grads[n] += g[n]
            del g
        for n in names:
            grads[n].div_(microbatches)
        return loss / microbatches, grads

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = local_grads(state["params"], batch)
        metrics = opt.update(grads, state["opt"], state["params"])
        del grads
        state["step"] += 1
        return state, dict(metrics, loss=loss)

    return train_step


class TrainWindow:
    """Fused K-step training window: ``steps_per_sync`` full train steps,
    each on the batch ``device_batch_at(data_cfg, state["step"])`` made on
    the card, with no host sync.  ``__call__`` returns the state (updated
    in place) and the stacked (K,) ``loss``, ``grad_norm`` and ``lr`` as
    device tensors; reading them is the window's one host sync."""

    def __init__(self, model: Model, opt: AdamW, data_cfg: DataConfig, *,
                 steps_per_sync: int, microbatches: int = 1,
                 compress_grads: bool = False, attn_impl: str = "kernel"):
        if steps_per_sync < 1:
            raise ValueError("steps_per_sync must be >= 1")
        _refuse_compression(compress_grads)
        if data_cfg.host_batch % microbatches:
            raise ValueError(
                f"host batch {data_cfg.host_batch} not divisible by "
                f"microbatches = {microbatches}")
        self.model = model
        self.opt = opt
        self.data_cfg = data_cfg
        self.steps_per_sync = int(steps_per_sync)
        self.windows_run = 0
        self._step_fn = make_train_step(model, opt,
                                        microbatches=microbatches,
                                        attn_impl=attn_impl)

    def __call__(self, state: TrainState
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        rows = {"loss": [], "grad_norm": [], "lr": []}
        for _ in range(self.steps_per_sync):
            batch = device_batch_at(self.data_cfg, state["step"])
            state, metrics = self._step_fn(state, batch)
            for name, col in rows.items():
                col.append(metrics[name])
        self.windows_run += 1
        return state, {name: torch.stack(col) for name, col in rows.items()}


def make_train_window(model: Model, opt: AdamW, *, steps_per_sync: int,
                      microbatches: int = 1, data_cfg: DataConfig,
                      **kw) -> TrainWindow:
    """Build the fused K-step train window (see ``TrainWindow``)."""
    return TrainWindow(model, opt, data_cfg, steps_per_sync=steps_per_sync,
                       microbatches=microbatches, **kw)
