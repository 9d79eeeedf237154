"""Error-feedback int8 gradient compression for data-parallel all-reduce
(torch counterpart of ``repro/optim/compress.py``, in its operation order).

Each gradient leaf is quantized to int8 against one absolute-max scale
(``max|x| / 127 + 1e-12``, rounded half to even, clipped to +-127), and the
quantization error is carried in an error-feedback buffer, so that the
compression bias vanishes over steps.  The all-reduce sums the int8
payloads in int32.

The data axis.  The JAX package runs ``compressed_psum*`` under a named
mapped axis (``jax.vmap(..., axis_name="dp")`` over per-shard gradients
stacked on a leading ``(shards,)`` axis).  Here that axis is the leading
axis of the stacked tensors themselves: the shared scale is the max over
every shard, the payload is summed over axis 0 in int32, and ``mean=True``
divides by the shard count.  The combined value is returned once (JAX's
vmap returns it replicated on every shard's row).

``CompressedOptimizer`` wraps the port's ``AdamW``; its state is
``{"inner": <AdamW state>, "err": <f32 error buffers>}`` (per-shard
``(shards, *p.shape)`` buffers when ``shards > 1``), so the error feedback
checkpoints with the Adam moments.  Like ``AdamW.update``, its ``update``
works IN PLACE on the state and the parameters: each error buffer holds
its corrected gradient and then the residual, so at full width the
compression needs no second copy of them.  It runs inside the profiler
range ``ef_compress``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
from torch.profiler import record_function

from repro_torch.optim.adamw import AdamW


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a (nested) dict of tensors, or a tensor."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _unzip(pairs):
    """Split a tree of (a, b) leaves into two trees."""
    if isinstance(pairs, dict):
        halves = {k: _unzip(v) for k, v in pairs.items()}
        return ({k: h[0] for k, h in halves.items()},
                {k: h[1] for k, h in halves.items()})
    return pairs


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of like's dtype on its device.  A divisor:
    on CUDA a division by a Python scalar multiplies by its rounded
    reciprocal, one by a tensor divides, as the CPU and JAX do."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def _scale(x: torch.Tensor) -> torch.Tensor:
    """``max|x| / 127 + 1e-12`` in x's dtype, as a 0-d tensor."""
    lo, hi = torch.aminmax(x)
    amax = torch.maximum(-lo, hi)
    return amax / _full(amax, 127.0) + 1e-12


def _payload(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The int8 payload of ``x`` at ``scale``, as integers in x's dtype
    (adding 0 turns a rounded -0.0 into the +0.0 an integer has, so that
    ``payload * scale`` is JAX's dequantized int bit for bit)."""
    return torch.div(x, scale).round_().clamp_(-127, 127).add_(0.0)


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, 0-d scale), the scale in x's dtype."""
    scale = _scale(x)
    return _payload(x, scale).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _feedback_(e: torch.Tensor) -> torch.Tensor:
    """``e`` holds a corrected f32 gradient: returns its dequantized int8
    value and leaves the residual ``e - deq`` in ``e``."""
    scale = _scale(e)
    deq = _payload(e, scale).mul_(scale)
    e.sub_(deq)
    return deq


def _combine_(e: torch.Tensor, mean: bool) -> torch.Tensor:
    """``e`` holds per-shard f32 values stacked on axis 0: returns their
    int8-payload sum over the shards (or mean) at the shared scale, and
    leaves each shard's residual ``e - dequant(quant(e))`` in ``e``."""
    scale = _scale(e)                 # the max over every shard: pmax
    q = _payload(e, scale)
    total = q[0].to(torch.int32)      # psum in int32, a shard at a time
    for i in range(1, q.shape[0]):
        total += q[i].to(torch.int32)
    e.sub_(q.mul_(scale))
    out = total.to(torch.float32).mul_(scale)
    if mean:
        out.div_(_full(out, e.shape[0]))
    return out


def compressed_psum(tree, *, mean: bool = False):
    """The int8-payload sum (``mean=True``: mean) over the leading shard
    axis of every leaf of ``tree``; each leaf comes back in its dtype
    without the shard axis.  A true sum, as ``jax.lax.psum``."""
    return compressed_psum_ef(tree, mean=mean)[0]


def compressed_psum_ef(tree, *, mean: bool = False):
    """``compressed_psum`` that also returns each shard's residual.

    Returns ``(combined, err)``: ``combined`` as ``compressed_psum`` gives
    it, ``err`` each shard's f32 quantization residual ``x -
    dequant(quant(x))`` (leading shard axis kept), which error-feedback
    data parallelism banks per worker before the reduce."""
    def one(x):
        xf = x.to(torch.float32, copy=True)
        return _combine_(xf, mean).to(x.dtype), xf

    return _unzip(_tree_map(one, tree))


def init_error_state(params) -> Any:
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)


def apply_error_feedback(grads, err_state):
    """Returns (compressed grads incl. carried error, new error state)."""
    def one(g, e):
        corrected = g.to(torch.float32) + e
        return _feedback_(corrected), corrected

    return _unzip(_tree_map(one, grads, err_state))


@dataclasses.dataclass(frozen=True)
class CompressedOptimizer:
    """Error-feedback int8 wrapper around the port's ``AdamW``.

    State is ``{"inner": <AdamW state>, "err": <f32 error buffers>}``.
    Each gradient is quantized exactly once and its residual banked where
    the quantization happened:

      * ``shards == 1``: ``update`` adds the carried error to the incoming
        gradient, int8-quantizes it, feeds the dequantized value to the
        inner optimizer and banks the residual;
      * ``shards > 1``: ``update`` takes per-shard gradients stacked on a
        leading ``(shards,)`` axis (the error buffers carry the same axis:
        per-worker error feedback), combines them through the
        ``compressed_psum_ef(mean=True)`` arithmetic, banking each
        shard's own residual before the reduce, and feeds the combined
        gradient to the inner optimizer un-re-quantized.
    """

    inner: AdamW
    shards: int = 1

    def _err_shape(self, p: torch.Tensor) -> Tuple[int, ...]:
        return ((self.shards,) + tuple(p.shape) if self.shards > 1
                else tuple(p.shape))

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"inner": self.inner.init(params),
                "err": {n: torch.zeros(self._err_shape(p),
                                       dtype=torch.float32, device=p.device)
                        for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict,
               params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``grads``: the reduced gradients (``shards == 1``) or per-shard
        gradients stacked on a leading ``(shards,)`` axis.  Updates the
        error buffers, the inner state and the parameters in place and
        returns the inner optimizer's metrics.  ``grads`` is consumed:
        each entry leaves the dict once its error buffer has taken it, so
        that at full width the stacked gradients do not live on beside
        the compressed ones."""
        comp = {}
        with record_function("ef_compress"):
            for n in sorted(params):
                e, g = state["err"][n], grads.pop(n)
                if tuple(g.shape) != tuple(e.shape):
                    raise ValueError(
                        f"{n}: gradient shape {tuple(g.shape)} != error "
                        f"buffer {tuple(e.shape)} (shards {self.shards})")
                e.add_(g)               # corrected = g.f32 + e, in place
                del g
                comp[n] = (_feedback_(e) if self.shards == 1
                           else _combine_(e, mean=True))
        return self.inner.update(comp, state["inner"], params)


def wrap_optimizer(opt: AdamW, shards: int = 1) -> CompressedOptimizer:
    """Error-feedback int8 compression around ``opt`` (see class above)."""
    if shards < 1:
        raise ValueError("shards must be >= 1")
    return CompressedOptimizer(inner=opt, shards=shards)
