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

Gradient compression (``compress_grads=True``) wraps the optimizer with
``optim/compress.py``'s error-feedback int8 ``CompressedOptimizer`` (build
and restore the state with ``effective_optimizer``).  With
``compress_shards > 1`` the batch's rows split into that many shard
groups, each microbatch-accumulates its own gradients (the groups in
turn), and the gradients, stacked on a leading ``(shards,)`` axis, combine
in the wrapped optimizer through the ``compressed_psum_ef(mean=True)``
arithmetic, each shard's residual banked in its own error buffer; the
loss is the mean over the shards.  This is the JAX trainer's schedule on
one device, where the shard groups stand in for data-parallel workers.

Traffic records: with ``record_traffic=True`` (the default) the first
window runs under ``launch/graph_analysis.py``'s ``OpCounter``, the
compression with the rest of the step; ``train_records`` gives its
per-step roofline terms and ``nvm_verdicts`` scores them with
``core/crosslayer.py``'s SRAM/STT/SOT tier model.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.crosslayer import analyze_train
from repro_torch.data.pipeline import DataConfig, device_batch_at
from repro_torch.launch.graph_analysis import OpCounter
from repro_torch.launch.roofline import Roofline
from repro_torch.models.api import Model
from repro_torch.models.common import Params
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.compress import wrap_optimizer
from repro_torch.sharding import constrain

TrainState = Dict[str, Any]  # {"params", "opt", "step"}


def effective_optimizer(opt: AdamW, compress_grads: bool = False,
                        compress_shards: int = 1):
    """The optimizer whose state the train step actually carries.

    ``compress_grads=True`` wraps ``opt`` with the error-feedback int8
    compressor (per-shard error buffers when ``compress_shards > 1``);
    build and restore train state with THIS, so that the state structure
    matches what ``make_train_step`` / ``TrainWindow`` expect.
    """
    return (wrap_optimizer(opt, shards=compress_shards) if compress_grads
            else opt)


def _check_compression(compress_grads: bool, compress_shards: int) -> None:
    if compress_shards < 1:
        raise ValueError("compress_shards must be >= 1")
    if compress_shards > 1 and not compress_grads:
        raise ValueError("compress_shards > 1 requires compress_grads=True")


def init_state(model: Model, opt,
               generator: torch.Generator) -> TrainState:
    """Weights drawn from ``generator`` by the model's init rules, a fresh
    state of ``opt`` (``AdamW`` or, for compressed steps, what
    ``effective_optimizer`` gives) and step 0, on the model's device."""
    params = model.init(generator)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model.device)}


def abstract_state(model: Model, opt) -> TrainState:
    """``init_state``'s structure as ``meta`` stand-ins (the dry run's;
    nothing is allocated)."""
    params = model.abstract_params()
    return {"params": params, "opt": opt.abstract_state(params),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def state_axes(model: Model, opt) -> TrainState:
    """The logical axes of every leaf of a train state."""
    axes = model.param_axes()
    return {"params": axes, "opt": opt.state_axes(axes), "step": ()}


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
                    compress_grads: bool = False, compress_shards: int = 1,
                    attn_impl: str = "kernel") -> Callable:
    """The train step ``(state, batch) -> (state, metrics)``; ``batch``
    holds (B, S) ``tokens`` and ``labels`` on the model's device, B a
    multiple of ``microbatches`` x ``compress_shards``.  Metrics are 0-d
    device tensors ``loss``, ``grad_norm`` and ``lr``.  Updates ``state``
    in place; build it with ``effective_optimizer(opt, compress_grads,
    compress_shards)``."""
    if microbatches < 1:
        raise ValueError("microbatches must be >= 1")
    _check_compression(compress_grads, compress_shards)
    opt_eff = effective_optimizer(opt, compress_grads, compress_shards)
    names = sorted(model.param_defs)

    def value_and_grad(params: Params, batch):
        """A parameter the loss does not reach (whisper's cross-attention
        on a batch without frames) gets a zero gradient, as under
        ``jax.grad``: AdamW then decays it, as JAX's does."""
        leaves = {n: params[n].detach().requires_grad_() for n in names}
        loss = model.loss(leaves, batch, attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, [leaves[n] for n in names],
                                    allow_unused=True,
                                    materialize_grads=True)
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

    def shard_grads(params: Params, batch):
        """(mean loss over the shards, each shard group's local grads
        stacked on a leading (shards,) axis); the groups run in turn and
        write into one stacked buffer a leaf."""
        groups = {k: _split_leading(x, compress_shards)
                  for k, x in batch.items()}
        losses, stacked = [], {}
        for i in range(compress_shards):
            l, g = local_grads(params, {k: x[i] for k, x in groups.items()})
            losses.append(l)
            for n in names:
                if n not in stacked:
                    stacked[n] = torch.empty(
                        (compress_shards,) + tuple(g[n].shape),
                        dtype=g[n].dtype, device=g[n].device)
                stacked[n][i].copy_(g[n])
            del g
        return torch.mean(torch.stack(losses)), stacked

    param_axes = model.param_axes()

    def reshard_grads(grads, lead=()):
        """Pin every gradient to its parameter's sharding before the
        optimizer (the identity with no sharder or on plain tensors):
        otherwise the elementwise update runs on gradients in whatever
        layout the backward left them."""
        return {n: constrain(g, lead + tuple(param_axes[n]))
                for n, g in grads.items()}

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if compress_shards == 1:
            loss, grads = local_grads(state["params"], batch)
            grads = reshard_grads(grads)
        else:
            loss, grads = shard_grads(state["params"], batch)
            grads = reshard_grads(grads, ("batch",))
        metrics = opt_eff.update(grads, state["opt"], state["params"])
        del grads
        state["step"] += 1
        return state, dict(metrics, loss=loss)

    return train_step


class TrainWindow:
    """Fused K-step training window: ``steps_per_sync`` full train steps,
    each on the batch ``device_batch_at(data_cfg, state["step"])`` made on
    the card, with no host sync.  ``__call__`` returns the state (updated
    in place) and the stacked (K,) ``loss``, ``grad_norm`` and ``lr`` as
    device tensors; reading them is the window's one host sync.
    ``record_traffic`` counts the first window for ``train_records`` /
    ``nvm_verdicts``; the trajectory is the same either way.
    ``compress_grads`` / ``compress_shards`` as ``make_train_step``;
    ``self.opt`` is the optimizer the state must be built with."""

    def __init__(self, model: Model, opt: AdamW, data_cfg: DataConfig, *,
                 steps_per_sync: int, microbatches: int = 1,
                 compress_grads: bool = False, compress_shards: int = 1,
                 attn_impl: str = "kernel", record_traffic: bool = True):
        if steps_per_sync < 1:
            raise ValueError("steps_per_sync must be >= 1")
        _check_compression(compress_grads, compress_shards)
        chunks = microbatches * compress_shards
        if data_cfg.host_batch % chunks:
            raise ValueError(
                f"host batch {data_cfg.host_batch} not divisible by "
                f"microbatches x compress_shards = {chunks}")
        self.model = model
        self.opt = effective_optimizer(opt, compress_grads, compress_shards)
        self.data_cfg = data_cfg
        self.steps_per_sync = int(steps_per_sync)
        self.record_traffic = bool(record_traffic)
        self.windows_run = 0
        self._traffic = None      # OpStats of the first window
        self._step_fn = make_train_step(
            model, opt, microbatches=microbatches,
            compress_grads=compress_grads, compress_shards=compress_shards,
            attn_impl=attn_impl)

    def __call__(self, state: TrainState
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        counting = self.record_traffic and self._traffic is None
        counter = OpCounter() if counting else contextlib.nullcontext()
        with counter:
            rows = {"loss": [], "grad_norm": [], "lr": []}
            for _ in range(self.steps_per_sync):
                batch = device_batch_at(self.data_cfg, state["step"])
                state, metrics = self._step_fn(state, batch)
                for name, col in rows.items():
                    col.append(metrics[name])
            out = {name: torch.stack(col) for name, col in rows.items()}
        if counting:
            self._traffic = counter.stats
        self.windows_run += 1
        return state, out

    # ---- train-mode NVM verdicts ---------------------------------------
    def train_records(self, mesh: Optional[str] = None) -> List[dict]:
        """Dry-run-shaped records of the window's counted traffic: one
        record with PER-STEP roofline terms of the K-step window,
        consumable by ``core.crosslayer.analyze_train`` (the record keys
        and shape name of the JAX window's)."""
        if self._traffic is None or not self.windows_run:
            return []
        K = self.steps_per_sync
        cfg = self.data_cfg
        return [{
            "arch": self.model.cfg.arch, "mesh": mesh or "1dev",
            "kind": "train",
            "shape": f"train_window_b{cfg.host_batch}_s{cfg.seq_len}_k{K}",
            "steps": self.windows_run * K,
            "roofline": Roofline.from_stats(self._traffic).terms(K)}]

    def nvm_verdicts(self, tier_mb: Optional[float] = None):
        """SRAM/STT/SOT tier verdicts on the window's counted traffic."""
        kw = {} if tier_mb is None else {"tier_mb": tier_mb}
        return analyze_train(self.train_records(),
                             device=self.model.device, **kw)


def make_train_window(model: Model, opt: AdamW, *, steps_per_sync: int,
                      microbatches: int = 1, data_cfg: DataConfig,
                      **kw) -> TrainWindow:
    """Build the fused K-step train window (see ``TrainWindow``)."""
    return TrainWindow(model, opt, data_cfg, steps_per_sync=steps_per_sync,
                       microbatches=microbatches, **kw)
