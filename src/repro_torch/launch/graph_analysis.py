"""Flops and bytes of the port's own op graph: the counterpart of the flops
and bytes half of ``repro/launch/hlo_analysis.py``.

The JAX package compiles each program a second time and walks its
optimized HLO; the port has no HLO, so it counts the aten ops it runs.
``OpCounter`` is a ``TorchDispatchMode``: every op that reaches the
dispatcher while it is active adds to an ``OpStats``.  It reads shapes,
dtypes and strides only, never values, so it never waits on the card (a
window counted under it passes ``torch.cuda.set_sync_debug_mode("error")``).
The rules follow the walker's, op for op:

- products (``mm``, ``addmm``, ``bmm``, ``baddbmm``): flops 2 x prod(out)
  x contracted size, as ``_dot_flops``; bytes the operands plus the
  output.  No other op counts flops;
- views and metadata (every op whose schema returns an alias of an input:
  ``view``, ``expand``, ``permute``, ``slice``, ``select``, ``detach``,
  ...; and ``_unsafe_view`` and the ``empty*`` factories) count nothing,
  as the walker's skipped ops and ``bitcast``;
- an operand counts by its own size (numel x element size), not its
  storage's, as the walker's ``dynamic-slice`` rule;
- in-place writes into a part of a tensor (``index_put_``,
  ``index_copy_``, ``masked_scatter_``, ``scatter_``, ``copy_``) count 2 x
  the update's bytes (``copy_``: its source read and its destination
  written), as the walker's ``dynamic-update-slice``: a cache row write
  does not count the whole cache;
- a copy between the host and the card counts nothing: the walker sees a
  program's arguments already on the device;
- every other op counts its distinct operands plus its outputs, as the
  walker counts an instruction that is not a dot, a slice or a fusion.
  The MoE dispatch's ops are counted so, as the walker counts their HLO:
  a stable ``sort`` (keys in; sorted keys and indices out, as XLA's sort
  of keys and an iota), ``gather`` and ``index`` (operand, indices,
  result), ``scatter_add_`` / ``index_add_`` (the whole operand in and
  out, the indices and the updates, as XLA's scatter) and ``cumsum``.

Collectives (``CollectiveStats``, the counterpart of the JAX package's
``parse_collectives``): each ``_c10d_functional`` collective that reaches
the counter (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce``, ``all_to_all_single``, their in-place, ``_out`` and
coalesced forms, ``_dtensor.shard_dim_alltoall``, and the eager
``c10d`` base ops of ``torch.distributed``) adds its count, payload and
ring-model link bytes by JAX's factors, op for op: all-gather and
all-to-all the output x (n-1)/n, all-reduce the output x 2(n-1)/n,
reduce-scatter the output x n x (n-1)/n, a permute (an
``all_to_all_single`` that sends the whole tensor to one peer) the
output x 1, with n the group size; and, as the walker does, 2 x its
output bytes to ``bytes``.  ``wait_tensor`` and
``_wrap_tensor_autograd`` count nothing.

Per device (``OpCounter(per_shard=True)``, the dry run's): an op on
DTensors reaches a dispatch mode with the DTensors' global shapes.  The
per-shard counter declines those (returns ``NotImplemented``, as torch's
``CommDebugMode`` does), so DTensor runs first and the counter sees
what it desugars into: the collectives of each redistribution and the op
on the local shards, i.e. the work of one device, as the JAX walker
counts one device's partitioned program.  Ops on ``FakeTensor``s
(DTensor's shape propagation) count nothing, and under this counter
neither does an op with no ``meta`` tensor (the dry run keeps every shard
on ``meta``; DTensor's redistribution planner computes shard offsets with
small host tensors when its cache misses): a collective counts wherever
it runs.  A kernel runs per device on the local shards
(``sharding/local.py``), so its declared traffic is one device's, as on
one card.

Autograd runs the backward on a worker thread on the card; the mode
reaches it with the rest of the thread-local state that autograd carries
to its workers, so a train window's backward is counted on the card as on
the CPU.

The kernels are launched through ``ctypes`` and never reach the
dispatcher, so each wrapper in ``kernels/ops.py`` runs inside
``kernel(name, traffic)``: it adds the call's declared flops (the
products of the kernel's plain version) and surface bytes (each input
read once, each output written once, a fused row write 2 x the row),
one ``kernel_calls[name]``, and runs the call outside the count, so
that the plain version a CPU tensor takes is not counted a second time.
A record is then the same number on the CPU and on the card.

A loop whose iterations run the same ops on the same shapes is counted
by its first iteration (``loop``); the others run outside the counter,
off the dispatch-mode stack, so counting a long loop costs one counted
iteration, not all of them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode,
                                          _get_current_dispatch_mode_stack,
                                          _pop_mode_temporarily)
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.launch.roofline import CollectiveStats

aten = torch.ops.aten

_PRODUCTS = frozenset((aten.mm, aten.addmm, aten.bmm, aten.baddbmm))
_FREE = frozenset((aten._unsafe_view, aten.empty, aten.empty_strided,
                   aten.empty_like, aten.new_empty, aten.new_empty_strided))
_HOST_COPIES = frozenset((aten._to_copy, aten.copy_))


_COLL_FREE = frozenset(("wait_tensor", "_wrap_tensor_autograd"))
# (namespace, op) -> the JAX walker's op name
_COLLECTIVES = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_out"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_out"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"):
        "reduce-scatter",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced_"): "all-reduce",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_base_"): "all-to-all",
}


def _group_size(group) -> int:
    """The size of a collective's group, given as a process group (or its
    script object) or a group name."""
    if hasattr(group, "size"):
        return int(group.size())
    from torch.distributed import distributed_c10d as c10d
    return int(c10d._resolve_process_group(group).size())


def _collective(func, args, kwargs, out
                ) -> Optional[Tuple[str, int, float]]:
    """(JAX op name, group size n, output bytes) of a collective, None for
    any other op.  ``output bytes`` is the LHS the HLO line would show:
    the gathered tensor of an all-gather, the shard of a reduce-scatter,
    the result of an all-reduce or all-to-all."""
    ns = func.namespace
    name = func.overloadpacket.__name__
    op = _COLLECTIVES.get((ns, name))
    if op is None:
        return None
    if ns == "c10d":
        # allreduce_(tensors, group, ...); the others (output, input,
        # group, ...)
        n = _group_size(args[1] if name == "allreduce_" else args[2])
        outputs = args[0]
        if name == "alltoall_base_" and sum(1 for x in args[4] if x) == 1:
            op = "collective-permute"
    else:
        if name.startswith(("all_gather", "reduce_scatter")):
            n = int(args[1] if name.startswith("all_gather") else args[2])
        elif name == "all_to_all_single":
            n = _group_size(args[3])
            if sum(1 for x in args[2] if x) == 1:
                op = "collective-permute"   # the whole tensor to one peer
        else:
            n = _group_size(args[-1] if name != "shard_dim_alltoall"
                            else args[3])
        outputs = kwargs.get("out", out)
    nbytes = float(tensor_bytes(*[t for t in tree_leaves(outputs)
                                  if isinstance(t, torch.Tensor)]))
    return op, n, nbytes


def tensor_bytes(*tensors: Optional[torch.Tensor]) -> int:
    """Bytes of each tensor by its own size (None counts nothing)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _update_bytes(packet, args) -> Optional[int]:
    """Bytes of the update of an in-place partial write (None for any
    other op)."""
    if packet is aten.index_put_:
        return tensor_bytes(args[2])
    if packet in (aten.index_copy_, aten.masked_scatter_):
        return tensor_bytes(args[-1])
    if packet is aten.scatter_:
        return args[2].numel() * args[0].element_size()
    return None


_views: Dict[object, bool] = {}


def _is_view(func) -> bool:
    """True when the op's schema returns an alias of an input (and writes
    nothing): the op moves no data."""
    if func not in _views:
        _views[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return _views[func]


def _cost(func, args, kwargs, out) -> Tuple[float, float]:
    """(flops, bytes) of one op by the rules of the module docstring."""
    packet = func.overloadpacket
    if packet in _FREE or _is_view(func):
        return 0.0, 0.0
    operands = [t for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)]
    outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if packet in _HOST_COPIES and len(
            {t.device.type for t in operands + outputs}) > 1:
        return 0.0, 0.0
    if packet is aten.copy_:
        return 0.0, float(tensor_bytes(args[0], args[1]))
    upd = _update_bytes(packet, args)
    if upd is not None:
        return 0.0, 2.0 * upd
    seen = {id(t): t for t in operands}
    nbytes = float(tensor_bytes(*seen.values(), *outputs))
    if packet in _PRODUCTS:
        a = args[0] if packet in (aten.mm, aten.bmm) else args[1]
        return 2.0 * outputs[0].numel() * a.shape[-1], nbytes
    return 0.0, nbytes


@dataclasses.dataclass
class OpStats:
    """What one counted region ran: total flops and bytes, both by op
    name, the kernel calls by kernel, and the collectives."""
    flops: float = 0.0
    bytes: float = 0.0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    collectives: CollectiveStats = dataclasses.field(
        default_factory=CollectiveStats)

    def add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.flops_by_op[name] = self.flops_by_op.get(name, 0.0) + flops
        self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nbytes

    def merge(self, other: "OpStats", times: int = 1) -> None:
        """Add ``other`` counted ``times`` over."""
        self.flops += times * other.flops
        self.bytes += times * other.bytes
        for mine, theirs in ((self.flops_by_op, other.flops_by_op),
                             (self.bytes_by_op, other.bytes_by_op),
                             (self.kernel_calls, other.kernel_calls)):
            for name, v in theirs.items():
                mine[name] = mine.get(name, 0) + times * v
        self.collectives.merge(other.collectives, times)


def _subclass_types():
    """(DTensor, FakeTensor) classes, imported when a counter is made."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    return DTensor, FakeTensor


_REFUSALS = re.compile(r"does not have a sharding strategy|Sharding "
                       r"propagation failed|redistribute from .* not "
                       r"supported")


def _unplaceable(err: RuntimeError) -> bool:
    """True for DTensor's refusal to place an op: no sharding strategy
    (a ``NotImplementedError``), its sharding propagation failed (a view
    that would split a sharded dim unevenly, a strategy that cannot take
    the inputs' placements), or the strategy it chose needs a
    redistribution it does not implement (a shard to a partial sum).  Any
    other error is the program's."""
    return _REFUSALS.search(str(err)) is not None


class OpCounter(TorchDispatchMode):
    """Count the ops run inside ``with OpCounter() as c:`` into
    ``c.stats`` (see the module docstring).  What runs is unchanged.
    ``per_shard`` counts the work of one device of a DTensor program."""

    def __init__(self, per_shard: bool = False):
        super().__init__()
        self.stats = OpStats()
        self.per_shard = per_shard
        self.replicated: Dict[str, int] = {}
        self._paused = 0
        self._desugaring = 0
        self._dtensor, self._fake = _subclass_types()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.per_shard and any(issubclass(t, self._dtensor)
                                  for t in types):
            if self._desugaring:
                return NotImplemented
            return self._desugar(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._paused or any(issubclass(t, self._fake) for t in types):
            return out
        coll = _collective(func, args, kwargs, out)
        if coll is not None:
            op, n, out_bytes = coll
            self.stats.collectives.add(op, n, out_bytes)
            self.stats.add(func.overloadpacket.__name__, 0.0,
                           2.0 * out_bytes)
            return out
        if func.overloadpacket.__name__ in _COLL_FREE:
            return out
        if self.per_shard and not any(
                isinstance(t, torch.Tensor) and t.device.type == "meta"
                for t in tree_leaves((args, kwargs, out))):
            return out        # DTensor's own bookkeeping on host tensors
        flops, nbytes = _cost(func, args, kwargs, out)
        if flops or nbytes:
            self.stats.add(func.overloadpacket.__name__, flops, nbytes)
        return out


    def _desugar(self, func, args, kwargs):
        """Run a DTensor op with this counter back on the stack, declining
        the op itself (``NotImplemented``), so that DTensor runs it and the
        counter sees its redistributions' collectives and the op on the
        local shards.  An op DTensor cannot place (no strategy, or a view
        that would split a sharded dim unevenly) runs on its inputs
        replicated over the innermost mesh dims, one more at a time until
        it runs, and with no strategy at all on the replicated tensors'
        local copies (``_on_replicas``): the gathers are counted, as GSPMD
        pays for an op it cannot partition, and ``replicated`` counts the
        op by name.  Only DTensor's refusals are retried
        (``_unplaceable``); any other error raises."""
        ndim = max(t.device_mesh.ndim for t in tree_leaves((args, kwargs))
                   if isinstance(t, self._dtensor))

        def replicated_from(keep):
            return lambda: func(
                *tree_map(lambda t: self._replicated(t, keep), args),
                **tree_map(lambda t: self._replicated(t, keep), kwargs))

        attempts = ([lambda: func(*args, **kwargs)]
                    + [replicated_from(k) for k in range(ndim - 1, -1, -1)]
                    + [lambda: self._on_replicas(func, args, kwargs)])
        self._desugaring += 1
        first = None
        try:
            with self:
                for i, attempt in enumerate(attempts):
                    outer, self.stats = self.stats, OpStats()
                    try:
                        out = attempt()
                    except RuntimeError as err:
                        self.stats = outer   # a failed attempt counts nothing
                        if not _unplaceable(err):
                            raise
                        first = first or err
                        continue
                    body, self.stats = self.stats, outer
                    outer.merge(body)
                    if i:
                        name = func.overloadpacket.__name__
                        self.replicated[name] = \
                            self.replicated.get(name, 0) + 1
                    return out
                raise first
        finally:
            self._desugaring -= 1

    def _on_replicas(self, func, args, kwargs):
        """An op DTensor has no strategy for at all: run it on the whole
        (replicated) tensors' local copies, as plain tensors, and return
        its outputs as replicated DTensors.  An in-place op writes the
        copy, not its DTensor operand: the trace reads shapes, not
        values."""
        from torch.distributed.tensor import DTensor, Replicate
        mesh = next(t.device_mesh for t in tree_leaves((args, kwargs))
                    if isinstance(t, self._dtensor))

        def local(t):
            if not isinstance(t, self._dtensor):
                return t
            return self._replicated(t, 0).to_local()

        out = func(*tree_map(local, args), **tree_map(local, kwargs))
        return tree_map(
            lambda t: DTensor.from_local(t, mesh,
                                         [Replicate()] * mesh.ndim,
                                         run_check=False)
            if isinstance(t, torch.Tensor) else t, out)

    def _replicated(self, t, keep: int):
        """A DTensor ``t`` with mesh dims ``keep`` and beyond replicated;
        anything else as it is."""
        from torch.distributed.tensor import Replicate
        if not isinstance(t, self._dtensor):
            return t
        want = list(t.placements)
        for m in range(keep, len(want)):
            if not want[m].is_replicate():
                want[m] = Replicate()
        if want == list(t.placements):
            return t
        return t.redistribute(t.device_mesh, want)


def active_counter() -> Optional[OpCounter]:
    """The ``OpCounter`` active on this thread, if any."""
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, OpCounter):
            return mode
    return None


@contextlib.contextmanager
def _uncounted(counter: OpCounter) -> Iterator[None]:
    """Run the body outside ``counter``: off the dispatch-mode stack when
    it is on top (so that the body's ops do not pass through Python at
    all), else paused."""
    if _get_current_dispatch_mode() is counter:
        with _pop_mode_temporarily():
            yield
        return
    counter._paused += 1
    try:
        yield
    finally:
        counter._paused -= 1


@contextlib.contextmanager
def kernel(name: str, traffic: Callable[[], Tuple[float, float]]
           ) -> Iterator[None]:
    """The boundary of one kernel call: under an active ``OpCounter``, add
    ``traffic()`` = (declared flops, surface bytes) and one call of
    ``name``, and count nothing inside; otherwise (no counter, or its
    count paused) nothing.  Under a per-shard counter the kernel runs on
    one device's local shards (``sharding/local.py``), so ``traffic()``
    reads local shapes."""
    counter = active_counter()
    if counter is None or counter._paused:
        yield
        return
    flops, nbytes = traffic()
    counter.stats.add(name, flops, nbytes)
    counter.stats.kernel_calls[name] = \
        counter.stats.kernel_calls.get(name, 0) + 1
    with _uncounted(counter):
        yield


def loop(n: int) -> Callable[[], contextlib.AbstractContextManager]:
    """Count a loop of ``n`` iterations that run the same ops on the same
    shapes (what the count reads; the values may differ) by its first
    iteration: returns the context each iteration runs in.  Under an
    active ``OpCounter`` the first iteration's count is added ``n`` times
    over and the others run outside the counter (``_uncounted``), so a
    long loop (a decode window, a per-token prefill scan) costs one
    counted iteration and counts what counting every iteration would.
    Otherwise nothing."""
    counter = active_counter()
    seen = [0]

    @contextlib.contextmanager
    def iteration() -> Iterator[None]:
        first = seen[0] == 0
        seen[0] += 1
        if counter is None:
            yield
        elif first:
            outer, counter.stats = counter.stats, OpStats()
            try:
                yield
            finally:
                body, counter.stats = counter.stats, outer
                outer.merge(body, n)
        else:
            with _uncounted(counter):
                yield

    return iteration

