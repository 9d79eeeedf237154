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
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode,
                                          _get_current_dispatch_mode_stack,
                                          _pop_mode_temporarily)
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

_PRODUCTS = frozenset((aten.mm, aten.addmm, aten.bmm, aten.baddbmm))
_FREE = frozenset((aten._unsafe_view, aten.empty, aten.empty_strided,
                   aten.empty_like, aten.new_empty, aten.new_empty_strided))
_HOST_COPIES = frozenset((aten._to_copy, aten.copy_))


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
    name, and the kernel calls by kernel."""
    flops: float = 0.0
    bytes: float = 0.0
    flops_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)

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


class OpCounter(TorchDispatchMode):
    """Count the ops run inside ``with OpCounter() as c:`` into
    ``c.stats`` (see the module docstring).  What runs is unchanged."""

    def __init__(self):
        super().__init__()
        self.stats = OpStats()
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            flops, nbytes = _cost(func, args, kwargs, out)
            if flops or nbytes:
                self.stats.add(func.overloadpacket.__name__, flops, nbytes)
        return out


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
    count paused) nothing."""
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
