"""Dispatch wrappers for the port's kernels.

A CPU tensor takes the kernel's plain PyTorch version; a CUDA tensor
launches the CUDA kernel (built at first use) or raises; any other device
raises, except a ``meta`` tensor inside ``plain_on_meta`` (the dry run's
shape trace, ``launch/dryrun.py``), which holds no data for a kernel to
read: flash attention takes its plain version for the shapes, the scans
return outputs of their shapes without walking their steps.  There is no fallback
from the kernel to the plain version.  On DTensors the flash kernel and
the scans run per device on the local shards (``sharding/local.py``).

``launches`` counts, per kernel, the launches the wrappers made: each
wrapper adds one where it launches its kernel and nowhere else, so a run
can show that its main path went through the kernels.

The serve and train wrappers are also the kernel boundary of the traffic
count (``launch/graph_analysis.py``): under an active ``OpCounter`` each
call adds its kernel's declared flops and surface bytes (the kernel
module's ``traffic``) and one ``kernel_calls`` entry, and nothing inside
it is counted, on the CPU's plain version as on the card's kernel.  What
runs is the same with or without a counter.

The two scans train under autograd through ``SSDScan`` and
``RGLRUGatedScan``: the kernel forward and a backward in plain PyTorch
(the RG-LRU's around two launches of the ungated kernel), counted op by
op as any plain code is.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from repro_torch.kernels import _build
from repro_torch.kernels import cache_sim as _cs
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import sampling as _sm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.launch.graph_analysis import kernel as _boundary
from repro_torch.sharding.local import is_dtensor, per_device

launches: Dict[str, int] = {"decode_attention": 0,
                            "paged_decode_attention": 0, "fused_sample": 0,
                            "cache_sim": 0, "cache_sim_ladder": 0,
                            "ssd_scan": 0, "rglru_scan": 0,
                            "flash_attention": 0}


_PLAIN_ON_META = False


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def plain_on_meta() -> Iterator[None]:
    """For the body, a wrapper given ``meta`` tensors runs its plain
    version (the dry run's shape trace: no data for a kernel to read);
    elsewhere a ``meta`` tensor raises."""
    global _PLAIN_ON_META
    prev, _PLAIN_ON_META = _PLAIN_ON_META, True
    try:
        yield
    finally:
        _PLAIN_ON_META = prev


def _on_cuda(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on
    another device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu" or (dev.type == "meta" and _PLAIN_ON_META):
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"no kernel for device {dev}")


# the scans' operand layouts for ``per_device``: (batch dim, channel dim,
# roles summed over)
_B_C2, _B_C1, _B, _C0 = (0, 2, ()), (0, 1, ()), (0, None, ()), (None, 0, ())
_C0_SUM_B, _B_SUM_C = (None, 0, ("batch",)), (0, None, ("chan",))


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    logit_cap: float = 0.0, q_offset: int = 0,
                    kv_len: Optional[int] = None, p_bf16: bool = False,
                    return_lse: bool = False):
    """Flash attention forward in the Pallas layout: q (B,H,Sq,hd); k/v
    (B,K,Skv,hd); ``window`` <= 0 global; query row i at position
    ``q_offset + i``; keys at or past ``kv_len`` (None: Skv) dead;
    ``p_bf16`` rounds the probabilities to bf16 before P.V -> o
    (B,H,Sq,hd), and with ``return_lse`` also lse (B,H,Sq) f32.  Any
    strides with a contiguous last dimension; the output takes q's.
    ``q_offset`` and ``kv_len`` are host ints; an argument the kernel does
    not take raises ValueError on either device."""
    with _boundary("flash_attention", lambda: _fa.traffic(q, k, v)):
        if not _on_cuda(q, k, v):
            kv_len = _fa.check_positions(q.shape[2], k.shape[2], causal,
                                         window, q_offset, kv_len, p_bf16)
            o, lse = _fa.flash_attention_plain(
                q, k, v, causal=causal, window=window, logit_cap=logit_cap,
                q_offset=q_offset, kv_len=kv_len, p_bf16=p_bf16)
            # the kernel's layout: o takes q's strides, so that what
            # follows runs the same ops on the CPU as on the card
            o = torch.empty_like(q).copy_(o)
        else:
            _fa.check_args(q, k, v, causal, window, logit_cap, q_offset,
                           kv_len, p_bf16)
            fn = _build.function("flash_attention", "flash_attention",
                                 _fa.ARGTYPES)
            o, lse = _fa.launch_cuda(fn, q, k, v, causal, window,
                                     logit_cap, q_offset, kv_len, p_bf16)
            launches["flash_attention"] += 1
    return (o, lse) if return_lse else o


def decode_attention(q, k, v, pos, window: int = 0, *,
                     logit_cap: float = 0.0):
    """Decode attention over caches that already hold the new row.

    q (B,H,hd); k/v (B,L,K,hd); pos (B,) int32; window int (<= 0 global)
    -> o (B,H,hd)."""
    with _boundary("decode_attention", lambda: _da.traffic(q, k, v, pos)):
        if not _on_cuda(q, k, v, pos):
            return _da.decode_attention_plain(q, k, v, pos, window,
                                              logit_cap=logit_cap)
        _da.check_args(q, k, v, None, None, pos, window)
        fn = _build.function("decode_attention", "decode_attention",
                             _da.ARGTYPES)
        out = _da.launch_cuda(fn, q, k, v, None, None, pos, window,
                              logit_cap)
        launches["decode_attention"] += 1
        return out


def decode_attention_fused(q, k, v, new_k, new_v, pos, window: int = 0, *,
                           logit_cap: float = 0.0):
    """Write ``new_k/new_v`` (B,K,hd) into the caches at each row's own
    ``pos[b]`` and attend ``k_idx <= pos[b]``, in one launch.

    The caches are updated IN PLACE (the JAX kernel returned aliased
    buffers); every row other than ``(b, pos[b])`` keeps its bits.
    Returns o (B,H,hd)."""
    with _boundary("decode_attention",
                   lambda: _da.traffic(q, k, v, pos, new_k, new_v)):
        if not _on_cuda(q, k, v, new_k, new_v, pos):
            return _da.decode_attention_fused_plain(
                q, k, v, new_k, new_v, pos, window, logit_cap=logit_cap)
        _da.check_args(q, k, v, new_k, new_v, pos, window)
        fn = _build.function("decode_attention", "decode_attention",
                             _da.ARGTYPES)
        out = _da.launch_cuda(fn, q, k, v, new_k, new_v, pos, window,
                              logit_cap)
        launches["decode_attention"] += 1
        return out


def paged_decode_attention(q, k, v, page_table, pos, window: int = 0, *,
                           logit_cap: float = 0.0):
    """Paged decode attention over pools that already hold the new row.

    q (B,H,hd); k/v pools (P,ps,K,hd); page_table (B,nb) int32; pos (B,)
    int32; window int (<= 0 global) -> o (B,H,hd)."""
    with _boundary("paged_decode_attention",
                   lambda: _pa.traffic(q, k, v, page_table, pos)):
        if not _on_cuda(q, k, v, page_table, pos):
            return _pa.paged_decode_attention_plain(
                q, k, v, page_table, pos, window, logit_cap=logit_cap)
        _pa.check_args(q, k, v, None, None, page_table, pos, window)
        fn = _build.function("paged_attention", "paged_decode_attention",
                             _pa.ARGTYPES)
        out = _pa.launch_cuda(fn, q, k, v, None, None, page_table, pos,
                              window, logit_cap)
        launches["paged_decode_attention"] += 1
        return out


def paged_decode_attention_fused(q, k, v, new_k, new_v, page_table, pos,
                                 window: int = 0, *,
                                 logit_cap: float = 0.0):
    """Write ``new_k/new_v`` (B,K,hd) through the page table at each row's
    ``pos[b]`` (page ``page_table[b, pos[b] // ps]``, row ``pos[b] % ps``;
    nothing where that page is past the table) and attend ``k_idx <=
    pos[b]``, in one launch.

    The pools are updated IN PLACE (the JAX kernel returned aliased
    buffers); every other pool row keeps its bits.  Precondition: each
    live row's boundary page is private to it.  Returns o (B,H,hd)."""
    with _boundary("paged_decode_attention",
                   lambda: _pa.traffic(q, k, v, page_table, pos, new_k,
                                       new_v)):
        if not _on_cuda(q, k, v, new_k, new_v, page_table, pos):
            return _pa.paged_decode_attention_fused_plain(
                q, k, v, new_k, new_v, page_table, pos, window,
                logit_cap=logit_cap)
        _pa.check_args(q, k, v, new_k, new_v, page_table, pos, window)
        fn = _build.function("paged_attention", "paged_decode_attention",
                             _pa.ARGTYPES)
        out = _pa.launch_cuda(fn, q, k, v, new_k, new_v, page_table, pos,
                              window, logit_cap)
        launches["paged_decode_attention"] += 1
        return out


def fused_sample(logits, temps, key):
    """One-launch greedy/temperature next-token sample.

    logits (B,V) f32; temps (B,) f32 (<= 0 greedy, bitwise first-occurrence
    argmax; > 0 Gumbel-max); key (2,) int64 uint32 words -> (B,) int32."""
    with _boundary("fused_sample", lambda: _sm.traffic(logits, temps, key)):
        if not _on_cuda(logits, temps, key):
            return _sm.fused_sample_plain(logits, temps, key)
        _sm.check_args(logits, temps, key)
        fn = _build.function("sampling", "fused_sample", _sm.ARGTYPES)
        out = _sm.launch_cuda(fn, logits, temps, key)
        launches["fused_sample"] += 1
        return out


def _cache_sim_fns(name: str):
    """The C entry ``name`` of ``csrc/cache_sim.cu`` and its scratch
    sizer."""
    argtypes = _cs.ARGTYPES if name == "cache_sim" else _cs.LADDER_ARGTYPES
    return (_build.function("cache_sim", name, argtypes),
            _build.function("cache_sim", "cache_sim_scratch_bytes",
                            _cs.SCRATCH_ARGTYPES, ctypes.c_longlong))


def cache_sim(set_ids, tags, *, num_sets: int, ways: int,
              sets_tile: Optional[int] = None):
    """LRU hits and misses of one trace of precomputed set ids (in [0,
    ``num_sets``)) and tags (T,) int32 against a cache of ``num_sets`` x
    ``ways``.  ``sets_tile`` is the JAX signature's tile of sets, checked
    as there (``num_sets`` a multiple of it; by default the largest
    divisor of ``num_sets`` up to 256); the CUDA kernel buckets the trace
    by set and walks each set with one thread, ``sets_tile`` threads a
    block.  Returns (2,) int64 [hits, misses]."""
    if not _on_cuda(set_ids, tags):
        return _cs.cache_sim_plain(set_ids, tags, num_sets=num_sets,
                                   ways=ways)
    if sets_tile is None:
        sets_tile = _cs.largest_divisor_tile(num_sets)
    _cs.check_args(set_ids, tags, num_sets, ways, sets_tile)
    out = _cs.launch_cuda(_cache_sim_fns("cache_sim"), set_ids, tags,
                          num_sets, ways, sets_tile)
    launches["cache_sim"] += 1
    return out


def cache_sim_ladder(traces, *, num_sets: Sequence[int], ways: int,
                     sets_tile: int = _cs.TILE):
    """LRU hits and misses of every (trace, rung) pair in one call: traces
    (W, T) int32 line ids >= 0, ``num_sets`` the per-rung set counts.
    ``sets_tile`` is the JAX signature's tile of sets, cut to the largest
    rung; the CUDA kernels bucket every (trace, rung) problem by set and
    walk each set with one thread, that many threads a block.  Returns
    (W, L, 2) int64 [hits, misses]."""
    if not _on_cuda(traces):
        return _cs.cache_sim_ladder_plain(traces, num_sets, ways=ways)
    _cs.check_ladder_args(traces, ways, sets_tile)
    out = _cs.launch_ladder_cuda(_cache_sim_fns("cache_sim_ladder"),
                                 traces, num_sets, ways, sets_tile)
    launches["cache_sim_ladder"] += 1
    return out


def _scan_on_meta(x, y_dtype, state: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A scan's outputs on ``meta`` (the dry run's shape trace, whose
    count is the kernel's declared traffic): y of x's shape in
    ``y_dtype`` and the f32 final state of shape ``state``, without
    walking the plain version's steps over tensors that hold no values."""
    return (torch.empty(x.shape, dtype=y_dtype, device="meta"),
            torch.empty(tuple(state), dtype=torch.float32, device="meta"))


def ssd_scan(x, dt, dtA, Bm, Cm, *, chunk: int,
             s0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD chunked scan in the model's layout: x (b,S,H,P); dt,
    dtA (b,S,H); Bm, Cm (b,S,N), one float dtype; ``chunk`` divides S; s0
    (b,H,P,N) f32 or None (zero start).  Returns (y like x, final state
    (b,H,P,N) f32).  On DTensors, per device on the local shards (batch
    and heads kept, the sequence whole)."""
    if is_dtensor(x):
        return per_device(
            lambda *a: ssd_scan(*a[:5], chunk=chunk, s0=a[5]),
            (x, dt, dtA, Bm, Cm, s0),
            (_B_C2, _B_C2, _B_C2, _B, _B, _B_C1), (_B_C2, _B_C1))
    with _boundary("ssd_scan",
                   lambda: _ssd.traffic(x, dt, dtA, Bm, Cm, chunk, s0)):
        if not _on_cuda(*(t for t in (x, dt, dtA, Bm, Cm, s0)
                          if t is not None)):
            if x.device.type == "meta":
                _ssd.check_chunk(x.shape[1], chunk)
                b, _, H, P = x.shape
                return _scan_on_meta(x, x.dtype, (b, H, P, Bm.shape[-1]))
            return _ssd.ssd_scan_plain(x, dt, dtA, Bm, Cm, chunk=chunk,
                                       s0=s0)
        _ssd.check_args(x, dt, dtA, Bm, Cm, chunk, s0)
        out = _ssd.launch_cuda(ssd_scan_fns(), x, dt, dtA, Bm, Cm, chunk,
                               s0)
        launches["ssd_scan"] += 1
        return out


class SSDScan(torch.autograd.Function):
    """``ssd_scan`` under autograd: kernel forward, plain backward, as
    ``models.attention.FlashAttention`` pairs them.

    Forward: ``ssd_scan`` (the CUDA kernels on CUDA tensors, the plain
    version on CPU ones); the inputs are saved.  Backward:
    ``ssd_scan.ssd_scan_backward`` in plain PyTorch on both devices: the
    chunks recomputed from their entering states under autograd, in
    groups capped by ``ssd_scan.GROUP_ELEMENTS`` (the JAX package
    recomputes them one at a time under ``jax.checkpoint``,
    ``repro/models/ssm.py``).  The
    gradient is the plain forward's at the saved inputs: the bf16 kernel
    rounds C.B^T, the weights and the entering states to bf16 for its
    tensor-core products (y within 0.125 of the plain version's), and
    the gradient does not follow that rounding.  The final state is an
    output with its own gradient; an unused one is zeros.  The backward
    runs inside the profiler range ``ssd_backward``."""

    @staticmethod
    def forward(ctx, x, dt, dtA, Bm, Cm, chunk: int,
                s0: Optional[torch.Tensor]):
        ctx.save_for_backward(x, dt, dtA, Bm, Cm, s0)
        ctx.chunk = chunk
        return ssd_scan(x, dt, dtA, Bm, Cm, chunk=chunk, s0=s0)

    @staticmethod
    def backward(ctx, dy, ds):
        x, dt, dtA, Bm, Cm, s0 = ctx.saved_tensors
        with record_function("ssd_backward"):
            if is_dtensor(x):       # per device, as the forward
                n = 6 if s0 is not None else 5
                *grads, ds0 = per_device(
                    lambda *a: _ssd.ssd_scan_backward(
                        *a[:5], ctx.chunk, *a[5:])[:n],
                    (x, dt, dtA, Bm, Cm, s0, dy, ds),
                    (_B_C2,) * 3 + (_B, _B, _B_C1, _B_C2, _B_C1),
                    (_B_C2,) * 3 + (_B_SUM_C,) * 2 + (_B_C1,) * (n - 5)
                ) + ((None,) if s0 is None else ())
            else:
                *grads, ds0 = _ssd.ssd_scan_backward(x, dt, dtA, Bm, Cm,
                                                     ctx.chunk, s0, dy, ds)
        return (*grads, None, ds0)


def ssd_scan_fns():
    """The C entry ``ssd_scan`` of ``csrc/ssd_scan.cu`` and its scratch
    sizer."""
    return (_build.function("ssd_scan", "ssd_scan", _ssd.ARGTYPES),
            _build.function("ssd_scan", "ssd_scan_scratch_bytes",
                            _ssd.SCRATCH_ARGTYPES, ctypes.c_longlong))


def rglru_scan(a, b, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU recurrence ``h_t = a_t * h_{t-1} + b_t``: a, b (B,S,R) f32;
    h0 (B,R) f32 or None (zero start).  Returns (y (B,S,R) f32, h_final
    (B,R) f32).  On DTensors, per device on the local shards (batch and
    channels kept, the sequence whole)."""
    if is_dtensor(a):
        return per_device(lambda *t: rglru_scan(*t), (a, b, h0),
                                (_B_C2, _B_C2, _B_C1), (_B_C2, _B_C1))
    with _boundary("rglru_scan", lambda: _rg.traffic(a, b, h0)):
        if not _on_cuda(*(t for t in (a, b, h0) if t is not None)):
            if a.device.type == "meta":
                return _scan_on_meta(a, torch.float32,
                                     (a.shape[0], a.shape[2]))
            return _rg.rglru_scan_plain(a, b, h0)
        _rg.check_args(a, b, h0)
        fn = _build.function("rglru_scan", "rglru_scan", _rg.ARGTYPES)
        out = _rg.launch_cuda(fn, a, b, h0)
        launches["rglru_scan"] += 1
        return out


def rglru_gated_scan(x, r, i, lam, h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU gates and recurrence in one launch: x, r, i (B,S,R) and lam
    (R,) of one float dtype; h0 (B,R) f32 or None (zero start).  ``a =
    exp(-8 softplus(lam) r)``, ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) i_t
    x_t``, in f32.  Returns (y (B,S,R) in x's dtype, h_final (B,R) f32);
    counted under ``rglru_scan``.  On DTensors, per device on the local
    shards, as ``rglru_scan``."""
    if is_dtensor(x):
        return per_device(lambda *t: rglru_gated_scan(*t),
                                (x, r, i, lam, h0),
                                (_B_C2, _B_C2, _B_C2, _C0, _B_C1),
                                (_B_C2, _B_C1))
    with _boundary("rglru_scan",
                   lambda: _rg.gated_traffic(x, r, i, lam, h0)):
        if not _on_cuda(*(t for t in (x, r, i, lam, h0) if t is not None)):
            if x.device.type == "meta":
                return _scan_on_meta(x, x.dtype, (x.shape[0], x.shape[2]))
            return _rg.rglru_gated_scan_plain(x, r, i, lam, h0)
        _rg.check_gated_args(x, r, i, lam, h0)
        fn = _build.function("rglru_scan", "rglru_gated_scan",
                             _rg.GATED_ARGTYPES)
        out = _rg.launch_gated_cuda(fn, x, r, i, lam, h0)
        launches["rglru_scan"] += 1
        return out


class RGLRUGatedScan(torch.autograd.Function):
    """``rglru_gated_scan`` under autograd.  Forward: the gated entry (one
    CUDA launch on CUDA tensors, the plain version on CPU ones); x, r, i,
    lam and h0 are saved.  Backward: ``rglru_scan.rglru_gated_scan_backward``
    with ``rglru_scan`` (the ungated kernel) run twice, once for h in f32
    and once, reversed in time, for the adjoint; the gate chain in plain
    PyTorch, inside the profiler range ``rglru_backward``.  An unused
    final state's gradient is zeros."""

    @staticmethod
    def forward(ctx, x, r, i, lam, h0: Optional[torch.Tensor]):
        ctx.save_for_backward(x, r, i, lam, h0)
        return rglru_gated_scan(x, r, i, lam, h0)

    @staticmethod
    def backward(ctx, dy, dh):
        with record_function("rglru_backward"):
            x, r, i, lam, h0 = ctx.saved_tensors
            if not is_dtensor(x):
                return _rg.rglru_gated_scan_backward(
                    rglru_scan, x, r, i, lam, h0, dy, dh)
            n = 5 if h0 is not None else 4   # per device, as the forward
            return per_device(
                lambda *a: _rg.rglru_gated_scan_backward(
                    rglru_scan, *a)[:n], (x, r, i, lam, h0, dy, dh),
                (_B_C2,) * 3 + (_C0, _B_C1, _B_C2, _B_C1),
                (_B_C2,) * 3 + (_C0_SUM_B,) + (_B_C1,) * (n - 4)
            ) + ((None,) if h0 is None else ())
