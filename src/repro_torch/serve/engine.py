"""Device-resident continuous-batching serve engine (torch counterpart of
``Engine`` / ``EngineReference`` / ``PagedEngine`` of
``repro/serve/engine.py``).

Per-slot decode state — last token, write position, active flag,
remaining budget, temperature — lives in (slots,) device tensors.  The
state machine:

  admit  (host, at sync points): free slots x queued requests -> ONE
         batched prefill of the admitted prompts (right-padded to the next
         power of two, capped at max_len); the prompt KV is scattered into
         the assigned cache rows and every other row keeps its bits.  Each
         admitted row's first token is sampled from its last prompt
         position's logits.  The recurrent families (ssm, hybrid) prefill
         with a masked per-token decode scan instead (``_prefill_scan``).
         The encdec family first encodes every admitted ``prompt +
         output`` in one encoder call at the fixed shape (slots, max_len),
         writes the admitted rows of the ``enc/out`` bank, and prefills
         against those rows (``_encode_rows``).
  decode (device, K ticks): a Python loop of ``ticks_per_sync`` ticks with
         no host sync inside; each tick decodes every slot at its own
         position (inactive slots too, at ``clip(pos, 0, max_len-1)``),
         samples, advances budgets and masks finished slots — a finished
         row emits -1 and stops changing its state.
  drain  (host, every K ticks): ONE transfer brings back the (K, slots)
         tokens, finish flags and finite-logit flags; outputs append,
         finished slots free, new requests admit.

The decode tick's attention and sampling are selected by ``attn_impl`` and
``sample_impl``: ``"kernel"`` (default) goes through the CUDA kernels of
``kernels/ops.py``, ``"plain"`` through their plain PyTorch versions.  On
CPU tensors the kernel wrappers take the plain versions themselves.

Resilience (``serve/resilience.py``, ``serve/chaos.py``): submit sheds at
``ShedPolicy.max_queue_depth``; requests past their ``deadline`` time out
in the queue or mid-decode; the drain's health check quarantines a slot
whose row gave non-finite logits or an out-of-vocab token (the tokens from
that tick on are dropped) and requeues its request, which resumes from
``prompt + output``, until ``max_retries`` is spent; ``preempt_slot``
requeues a running request the same way.  An attached ``FaultPlan`` acts
at the sites ``pre_admit``, ``pre_window`` and ``window_launch``.  The
``WindowWatchdog`` retries the launch gate (the ``window_launch`` site)
and then degrades, counting ``window_fallbacks``; the window itself runs
once, on the same kernels, after the gate, so an error raised inside it
propagates out of ``step()``: the fused decode kernels write the cache
inside the launch and a CUDA error is sticky, so nothing there may be
retried.  An attached ``Tracer`` (``serve/telemetry.py``) records the
prefill, decode-window and host-drain spans as the host observes them.

``PagedEngine`` serves the same tick out of a shared physical page pool
with radix-tree prefix sharing and copy-on-write boundary pages.

``EngineReference`` is the per-tick oracle: per-token prefill through
``decode_step``, one host round-trip per tick, sampling in Python.

Traffic records (``record_traffic=True``, the default): the first decode
window and the first prefill of each padded length run under
``launch/graph_analysis.py``'s ``OpCounter`` (nothing runs twice, nothing
waits on the card; the window's ticks and the recurrent prefill scan's
steps are counted by their first, ``graph_analysis.loop``, so counting
costs one tick or step of each); ``serve_records()`` turns the counts
into per-tick and per-call roofline terms, and ``nvm_verdicts()`` scores
them with ``core/crosslayer.py``'s SRAM/STT/SOT tier model.

State banks (``Model.state_banks``): KV banks need no reset, since reads
are position-guarded; the ``enc`` bank neither, since an admission
overwrites its row whole.  The GUARDED banks (``"recurrent"``, ``"ring"``)
carry state no position masks: every decode tick merges them under the
pre-update active mask (frozen rows keep their bits), every site that
frees a slot resets its rows, and an admitted row starts from the reset
values.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Deque, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core.crosslayer import (RECURRENT_READ_FRACTION,
                                         analyze_serve)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.sampling import fused_sample_plain
from repro_torch.launch import graph_analysis
from repro_torch.launch.graph_analysis import OpCounter
from repro_torch.launch.roofline import Roofline
from repro_torch.models.api import (Model, UnsupportedFamilyError,
                                    serve_families)
from repro_torch.serve.paged import (PagePool, PagePoolExhausted,
                                     RadixTree, pages_for)
from repro_torch.serve.resilience import (DONE, FAILED, PENDING, QUEUED,
                                          RUNNING, SHED, TERMINAL_STATES,
                                          TIMED_OUT, ShedPolicy,
                                          WindowWatchdog, check_request)

IMPLS = ("plain", "kernel")
GUARDED_KINDS = ("recurrent", "ring")


def _where_rows(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor,
                axis: int) -> torch.Tensor:
    """Row-masked merge: ``new`` where ``mask`` (a (B,) bool over the bank's
    slot axis ``axis``) else ``old``, other axes broadcast."""
    m = mask.reshape(tuple(-1 if d == axis else 1 for d in range(old.ndim)))
    return torch.where(m, new, old)


def _reset_rows(cache, slot: int, banks, resets) -> None:
    """Re-initialize, IN PLACE, slot ``slot``'s rows of the guarded
    (recurrent/ring) banks to their init fill ``resets[name]`` (-1 for the
    ring position bank, 0 elsewhere); kv banks and every other row keep
    their bits."""
    for n, b in banks.items():
        if b.kind in GUARDED_KINDS:
            cache[n].narrow(b.batch_axis, slot, 1).fill_(resets[n])


def _bank_meta(model: Model, slots: int, max_len: int):
    """(banks, reset fill per bank, names of the guarded banks)."""
    banks = model.state_banks()
    defs = model.cache_defs(slots, max_len)
    resets = {n: (d.const if d.init == "const" else 0)
              for n, d in defs.items()}
    guarded = frozenset(n for n, b in banks.items()
                        if b.kind in GUARDED_KINDS)
    return banks, resets, guarded


@dataclasses.dataclass
class Request:
    """One serve request, carrying its own latency record.

    Tick-domain semantics (as in the JAX package): ``engine.ticks`` counts
    completed decode ticks; a request admitted at tick ``T`` has
    ``admit_tick = first_token_tick = T``; decode token ``i >= 1`` is
    emitted at tick ``T + i - 1``.  Wall-clock stamps
    (``time.perf_counter``) are taken when the host observes the event.
    ``arrival`` is the intended arrival tick of generated traffic
    (``serve/workload.py``); tick-domain latencies count from it when set,
    else from ``submit_tick``.

    The request ends in exactly one terminal state (``_finalize`` acts
    once): ``DONE`` (the only one that sets ``done``), ``SHED``
    (backpressure at submit, or page-pool defers past
    ``ShedPolicy.max_defers``), ``TIMED_OUT`` (``deadline``, an absolute
    engine tick, passed while queued or mid-decode; the partial output is
    a prefix of the unfaulted answer) or ``FAILED`` (malformed, or the
    quarantine retry budget spent); ``reason`` says why for the non-DONE
    states.  Requeued work (quarantine retries, preemption, resubmission)
    resumes from ``prompt + output``, and keeps its first submit and
    admission stamps.
    """
    uid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    done_tick: Optional[int] = None   # engine tick of the final token
    arrival: Optional[float] = None   # intended arrival (ticks; traffic gen)
    submit_tick: Optional[int] = None
    submit_time: Optional[float] = None
    admit_tick: Optional[int] = None
    admit_time: Optional[float] = None
    first_token_tick: Optional[int] = None
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None
    state: str = PENDING
    reason: Optional[str] = None      # why SHED / TIMED_OUT / FAILED
    deadline: Optional[float] = None  # absolute engine tick; opt-in
    retries: int = 0                  # health-check quarantine requeues
    preemptions: int = 0              # preempt_slot requeues
    defers: int = 0                   # pool-exhausted admission defers

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def _mark_admitted(self, tick: int, now: float) -> None:
        """Stamp admission == first-token emission; only the FIRST
        admission stamps, so a requeued request keeps its TTFT."""
        self.state = RUNNING
        if self.admit_tick is None:
            self.admit_tick = self.first_token_tick = tick
            self.admit_time = self.first_token_time = now

    def _finalize(self, state: str, tick: int, now: float,
                  reason: Optional[str] = None) -> None:
        """Enter a terminal state exactly once (later calls are no-ops)."""
        if self.terminal:
            return
        self.state = state
        self.reason = reason
        self.done = state == DONE
        self.done_tick = tick
        self.done_time = now

    def _mark_done(self, tick: int, now: float) -> None:
        self._finalize(DONE, tick, now)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _soft_submit(engine, req: Request) -> bool:
    """Queue ``req``; never raises.  A malformed request ends FAILED with
    the validation message as its reason, and a submit past
    ``max_queue_depth`` is shed.  Only the first submit stamps the
    request, so a resubmitted request keeps its latency record.  Returns
    True iff queued."""
    now = time.perf_counter()
    try:
        check_request(req, engine.max_len)
    except ValueError as e:
        req._finalize(FAILED, engine.ticks, now, reason=str(e))
        engine._rstats["failed"] += 1
        return False
    if req.submit_tick is None:
        req.submit_tick = engine.ticks
        req.submit_time = now
    pol = engine.shed_policy
    if (pol.max_queue_depth is not None
            and len(engine._queue) >= pol.max_queue_depth):
        req._finalize(
            SHED, engine.ticks, now,
            reason=(f"queue depth {len(engine._queue)} at limit "
                    f"{pol.max_queue_depth}"))
        engine._rstats["shed"] += 1
        return False
    req.state = QUEUED
    engine._queue.append(req)
    return True


def _drop_expired(engine) -> None:
    """Time out queued requests whose deadline already passed: they would
    only waste prefill work to time out mid-decode."""
    if not engine._queue or not engine.shed_policy.enforce_deadlines:
        return
    keep: Deque[Request] = collections.deque()
    now = time.perf_counter()
    while engine._queue:
        r = engine._queue.popleft()
        if r.deadline is not None and engine.ticks > r.deadline:
            r._finalize(
                TIMED_OUT, engine.ticks, now,
                reason=(f"deadline {r.deadline:g} expired in queue at "
                        f"tick {engine.ticks}"))
            engine._rstats["timed_out"] += 1
        else:
            keep.append(r)
    engine._queue = keep


def _drain_until_done(engine, max_ticks: int) -> int:
    """Step until queue and slots are empty or the tick budget is spent.
    A window runs only if all its ``ticks_per_sync`` ticks fit in
    ``max_ticks``.  A resource stall (nothing active and nothing
    admissible, e.g. a page pool a fault holds) advances the tick clock by
    K, so that deadlines expire and the budget ends the loop.  Returns the
    number of unfinished requests."""
    start = engine.ticks
    k = engine.ticks_per_sync
    while engine._queue or any(r is not None for r in engine.slot_req):
        if engine.ticks - start + k > max_ticks:
            break
        if engine.step() == 0:
            if not engine._queue:
                break
            if engine._last_admitted == 0:
                engine.ticks += k
    return len(engine._queue) + sum(r is not None for r in engine.slot_req)


def _new_rstats() -> Dict[str, int]:
    """The resilience counters of ``resilience_stats()``, at zero."""
    return {"failed": 0, "shed": 0, "timed_out": 0, "quarantined": 0,
            "retried": 0, "preempted": 0, "window_retries": 0,
            "window_fallbacks": 0}


def _check_model(model: Model, device: DeviceLike, name: str,
                 max_len: int):
    if "dense" not in model.serve_modes:
        raise UnsupportedFamilyError(model.cfg.family,
                                     serve_families("dense"), name)
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"{name} on {dev} but the model is on "
                         f"{model.device}")
    if model.cfg.family == "encdec" and max_len > model.max_seq:
        # the learned decoder positions end at max_seq
        raise ValueError(f"{name}: max_len {max_len} > the model's max_seq "
                         f"{model.max_seq} (its pos/dec rows)")
    return model.device


def _encode_rows(engine, slots: List[int], effs: List[List[int]]
                 ) -> torch.Tensor:
    """Encode the effective prompts ``effs`` of ``slots`` in ONE encoder
    call at the fixed shape (engine.slots, engine.max_len), the other rows
    zero, and write those slots' rows of the ``enc/out`` bank (every other
    row keeps its bits).  Both engines encode through here, so a row's
    output is the same bits in either (``Model.encode_prompt``).  Returns
    the written rows (len(slots), max_len, D), in ``slots`` order."""
    tokens = np.zeros((engine.slots, engine.max_len), np.int32)
    lens = np.zeros(engine.slots, np.int32)
    for s, e in zip(slots, effs):
        tokens[s, :len(e)] = e
        lens[s] = len(e)
    dev = engine.device
    enc = engine.model.encode_prompt(engine.params,
                                     torch.from_numpy(tokens).to(dev),
                                     torch.from_numpy(lens).to(dev))
    rows = torch.tensor(slots, device=dev)
    bank = engine.cache["enc/out"]
    bank[rows] = enc[rows].to(bank.dtype)
    return bank[rows]


class Engine:
    """Fused continuous-batching engine (see module docstring).

    ``ticks_per_sync`` (K) is the drain cadence: larger K amortizes host
    round-trips over more decode ticks but delays slot reuse to window
    boundaries.  Temperature draws use two key words per sampling call
    from the engine's ``torch.Generator`` (seeded by ``seed``); they
    differ from ``jax.random``'s, so across frameworks only greedy tokens
    agree.  ``record_traffic`` counts the first decode window and the
    first prefill of each padded length for ``serve_records`` /
    ``nvm_verdicts``; what the engine emits is the same either way.
    ``charge_prefill_ticks`` charges each admission
    ``ceil(prefilled tokens / slots)`` ticks before stamping it, so that
    tick-domain TTFT sees the prompt work.  ``watchdog`` guards only the
    launch gate before each window (the ``window_launch`` fault site):
    its retries and its ``timeout_s`` bound that gate, never the window's
    device work, which runs once and whose errors propagate out of
    ``step()``.  ``health_check=False`` lets non-finite or out-of-vocab
    rows decode on, as the JAX engine does with it off.
    ``prefill_attn_impl`` is the dense admission prefill's attention
    (``Model.prefill``'s ``attn_impl``): "plain" (the default, as the JAX
    engine's "naive") or "kernel", the flash kernel (its "chunked"); the
    recurrent families' per-token prefill scan and ``PagedEngine``'s
    suffix prefill do not read it, as in JAX.
    """

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 eos_id: Optional[int] = None, seed: int = 0,
                 ticks_per_sync: int = 8, attn_impl: str = "kernel",
                 sample_impl: str = "kernel", record_traffic: bool = True,
                 device: DeviceLike = None, tracer=None,
                 charge_prefill_ticks: bool = False,
                 shed_policy: Optional[ShedPolicy] = None,
                 watchdog: Optional[WindowWatchdog] = None,
                 fault_plan=None, health_check: bool = True,
                 prefill_attn_impl: str = "plain"):
        self.device = _check_model(model, device, "Engine", max_len)
        if attn_impl not in IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {IMPLS}")
        if prefill_attn_impl not in IMPLS:
            raise ValueError(f"prefill_attn_impl {prefill_attn_impl!r} not "
                             f"in {IMPLS}")
        if sample_impl not in IMPLS:
            raise ValueError(f"sample_impl {sample_impl!r} not in {IMPLS}")
        if int(ticks_per_sync) < 1:
            raise ValueError("ticks_per_sync must be >= 1")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.seed = seed
        self.ticks_per_sync = int(ticks_per_sync)
        self.attn_impl = attn_impl
        self.prefill_attn_impl = prefill_attn_impl
        self.sample_impl = sample_impl
        self.record_traffic = bool(record_traffic)
        self.charge_prefill_ticks = bool(charge_prefill_ticks)
        self.tracer = tracer
        self.shed_policy = shed_policy if shed_policy is not None \
            else ShedPolicy()
        self.watchdog = watchdog if watchdog is not None else WindowWatchdog()
        self.fault_plan = fault_plan
        self.health_check = bool(health_check)
        self._vocab = int(model.cfg.vocab_size)
        self._banks, self._bank_reset, self._guarded = _bank_meta(
            model, slots, max_len)
        # counted traffic, kept across reset() as the programs it counts
        self._traffic: Dict[str, object] = {"decode": None, "prefill": {}}
        self.reset()

    # ---- state ----------------------------------------------------------
    def _fresh_cache(self):
        """Cache buffers for ``reset`` (PagedEngine makes page pools)."""
        return self.model.init_cache(self.slots, self.max_len)

    def reset(self) -> None:
        """Clear cache, slot state, queue and counters (the counted
        traffic is kept)."""
        dev = self.device
        self.cache = self._fresh_cache()
        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(self.seed)
        self.slot_req: List[Optional[Request]] = [None] * self.slots
        self._queue: Deque[Request] = collections.deque()
        z = dict(device=dev)
        self._state = {
            "last": torch.zeros(self.slots, dtype=torch.int32, **z),
            "pos": torch.zeros(self.slots, dtype=torch.int32, **z),
            "active": torch.zeros(self.slots, dtype=torch.bool, **z),
            "remaining": torch.zeros(self.slots, dtype=torch.int32, **z),
            "temps": torch.zeros(self.slots, dtype=torch.float32, **z),
        }
        self.ticks = 0
        self.counts = {"decode_ticks": 0, "prefill_calls": 0,
                       "prefill_steps": 0, "prefill_calls_by_len": {}}
        self._poison_host = np.zeros(self.slots, bool)   # chaos NaN operand
        self._degraded = False      # sticky: the launch gate gave up
        self._last_admitted = 0     # run-loop stall detection
        self._rstats = _new_rstats()

    # ---- device programs ------------------------------------------------
    def _sample(self, lg: torch.Tensor, temps: torch.Tensor) -> torch.Tensor:
        """Next tokens for (B, V) f32 logits; two fresh key words per call,
        drawn on the device (no host sync)."""
        key = torch.randint(0, 2 ** 32, (2,), generator=self._gen,
                            device=self.device, dtype=torch.int64)
        if self.sample_impl == "kernel":
            return kernel_ops.fused_sample(lg, temps, key)
        return fused_sample_plain(lg, temps, key)

    def _decode_kwargs(self) -> dict:
        """Extra ``decode_step`` arguments of the decode tick (PagedEngine
        passes its page table)."""
        return {}

    def _pre_window(self) -> None:
        """Host work before a decode window, so that none is needed inside
        it (PagedEngine uploads a changed page table here)."""

    def _release_slot(self, s: int) -> None:
        """Free slot ``s``: every site that frees a slot comes here.  The
        guarded banks' rows of the slot go back to their reset values
        (positionless state would otherwise leak into the next occupant);
        PagedEngine also returns the slot's page references."""
        self.slot_req[s] = None
        if self._guarded:
            _reset_rows(self.cache, s, self._banks, self._bank_reset)

    # ---- traffic accounting --------------------------------------------
    @contextlib.contextmanager
    def _counted(self, P: Optional[int] = None) -> Iterator[None]:
        """Run the body under ``OpCounter`` when it is the first decode
        window (``P`` None) or the first prefill of padded length ``P`` and
        traffic is recorded, and keep the count."""
        seen = (self._traffic["decode"] if P is None
                else self._traffic["prefill"].get(P))
        if not self.record_traffic or seen is not None:
            yield
            return
        with OpCounter() as counter:
            yield
        if P is None:
            self._traffic["decode"] = counter.stats
        else:
            self._traffic["prefill"][P] = counter.stats

    def _prefill_call(self, P: int):
        """One prefill call of padded length ``P``: counts it by length and
        returns the context it runs in (``_counted``)."""
        by_len = self.counts["prefill_calls_by_len"]
        by_len[P] = by_len.get(P, 0) + 1
        return self._counted(P)

    def _window(self, poison: Optional[torch.Tensor] = None):
        """K decode ticks, no host sync.  Returns (3, K, slots) int32:
        emitted tokens (-1 for inactive rows), finish flags, finite-logit
        flags.  ``poison`` (a (slots,) bool on the device, given only when
        a fault plan is attached) turns its rows' logits to NaN on every
        tick of the window.  The first window is counted (``_counted``)."""
        with self._counted():
            return self._ticks(poison)

    def _ticks(self, poison: Optional[torch.Tensor]):
        st = self._state
        last, pos, active = st["last"], st["pos"], st["active"]
        remaining, temps = st["remaining"], st["temps"]
        toks, fins, oks = [], [], []
        # every tick runs the same ops on the same shapes: a counted
        # window counts its first tick K times over
        tick = graph_analysis.loop(self.ticks_per_sync)
        for _ in range(self.ticks_per_sync):
            with tick():
                safe_pos = pos.clamp(0, self.max_len - 1)
                logits, new = self.model.decode_step(
                    self.params, self.cache, {"tokens": last[:, None]},
                    safe_pos, attn_impl=self.attn_impl,
                    **self._decode_kwargs())
                if self._guarded:
                    # guarded banks advance on every row: freeze the
                    # inactive ones under the PRE-update mask, so a row
                    # finishing this tick keeps this tick's state (kv banks
                    # need no merge)
                    new = {n: (_where_rows(active, t, self.cache[n],
                                           self._banks[n].batch_axis)
                               if n in self._guarded else t)
                           for n, t in new.items()}
                self.cache = new
                lg = logits[:, -1]
                if poison is not None:
                    lg = torch.where(poison[:, None], float("nan"), lg)
                oks.append(torch.isfinite(lg).all(dim=-1))
                tok = self._sample(lg, temps)
                fin = (remaining - 1 <= 0) | (pos + 1 >= self.max_len)
                if self.eos_id is not None:
                    fin = fin | (tok == self.eos_id)
                fin = active & fin
                toks.append(torch.where(active, tok, -1))
                fins.append(fin)
                last = torch.where(active, tok, last)
                pos = torch.where(active, pos + 1, pos)
                remaining = torch.where(active, remaining - 1, remaining)
                active = active & ~fin
        self._state = {"last": last, "pos": pos, "active": active,
                       "remaining": remaining, "temps": temps}
        return torch.stack([torch.stack(toks).to(torch.int32),
                            torch.stack(fins).to(torch.int32),
                            torch.stack(oks).to(torch.int32)])

    def _scatter_bank(self, name: str, fresh: torch.Tensor,
                      rows: torch.Tensor, valid: torch.Tensor) -> None:
        """Write ``fresh`` (prefill KV, seq length P, batch = admitted rows)
        into the cache rows ``rows`` where ``valid[row, col]``, along the
        bank's batch/seq axes; every other element keeps its bits."""
        bank = self._banks[name]
        ba, sa = bank.batch_axis, bank.seq_axis
        old = self.cache[name]
        P = fresh.shape[sa]
        idx = tuple(rows if d == ba else (slice(0, P) if d == sa
                                          else slice(None))
                    for d in range(old.ndim))
        mask = valid.reshape(tuple(
            valid.shape[0] if d == ba else (P if d == sa else 1)
            for d in range(old.ndim)))
        old[idx] = torch.where(mask, fresh.to(old.dtype), old[idx])

    # ---- admission ------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request; never raises (malformed requests end FAILED,
        backpressure sheds).  Returns True iff queued."""
        return _soft_submit(self, req)

    def _admit(self) -> int:
        """Admit queued requests into free slots with one batched prefill
        (the masked per-token scan for the guarded families).  A requeued
        request resumes from ``prompt + output``: its emitted tokens are
        prefilled again (and, encdec, encoded again) and its budget is cut
        by them, so a greedy continuation equals an uninterrupted run.
        The encdec encoder call runs before the prefill and outside its
        counted traffic, as the JAX engine's encoder program is outside
        its analysed prefill."""
        self._last_admitted = 0
        _drop_expired(self)
        free = [i for i in range(self.slots) if self.slot_req[i] is None]
        take = min(len(free), len(self._queue))
        if take == 0:
            return 0
        pairs = [(free[i], self._queue.popleft()) for i in range(take)]
        if self._guarded:
            return self._prefill_scan(pairs)
        eff = [list(r.prompt) + list(r.output) for _, r in pairs]
        P = min(self.max_len, _next_pow2(max(map(len, eff))))
        tokens = np.zeros((take, P), np.int32)
        lens = np.zeros(take, np.int32)
        for i, e in enumerate(eff):
            tokens[i, :len(e)] = e
            lens[i] = len(e)
        dev = self.device
        rows = torch.tensor([s for s, _ in pairs], device=dev)
        lens_t = torch.from_numpy(lens).to(dev)
        t_launch = time.perf_counter()
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        if self.model.cfg.family == "encdec":
            batch["enc_out"] = _encode_rows(self, [s for s, _ in pairs],
                                            eff)
        with self._prefill_call(P):
            logits, fresh = self.model.prefill(
                self.params, batch, logits_at=(lens_t - 1).clamp(0, P - 1),
                attn_impl=self.prefill_attn_impl)
            valid = (torch.arange(P, device=dev)[None, :] < lens_t[:, None])
            for name, t in fresh.items():
                self._scatter_bank(name, t, rows, valid)
            del fresh
            first = self._start_rows(pairs, rows, logits[:, 0], lens_t)
        host = first.cpu()
        now = time.perf_counter()
        self._trace_prefill(P, take, t_launch, now)
        self._seat(pairs, host, int(lens.sum()), now)
        return take

    def _prefill_scan(self, pairs) -> int:
        """Masked per-token prefill of the admitted slots, for the families
        whose guarded banks cannot take a scattered full-sequence cache.
        The admitted rows start from the banks' reset values; each prompt
        position (of ``prompt + output``) runs one decode step on those
        rows alone, and its result merges only into rows still inside
        their prompt (``t < len``), so each admitted row ends in the state
        the reference engine's per-token loop leaves.  The rows go back
        into their slots at the end; no other slot's rows are read or
        written.  Runs ``max(len)`` steps (the JAX engine runs to the
        power-of-two pad, whose extra steps merge nothing; the traffic is
        keyed by that pad)."""
        dev = self.device
        n = len(pairs)
        eff = [list(r.prompt) + list(r.output) for _, r in pairs]
        lens = [len(e) for e in eff]
        L = max(lens)
        tokens = np.zeros((n, L), np.int32)
        for i, e in enumerate(eff):
            tokens[i, :lens[i]] = e
        tok = torch.from_numpy(tokens).to(dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        rows = torch.tensor([s for s, _ in pairs], device=dev)
        P = min(self.max_len, _next_pow2(L))
        t_launch = time.perf_counter()
        with self._prefill_call(P):
            sub = self.model.init_cache(n, self.max_len)
            last_lg = torch.zeros((n, self.model.cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
            step = graph_analysis.loop(L)    # counted by its first step
            for t in range(L):
                with step():
                    pos = torch.full((n,), t, dtype=torch.int32, device=dev)
                    logits, new = self.model.decode_step(
                        self.params, sub, {"tokens": tok[:, t:t + 1]}, pos,
                        attn_impl=self.attn_impl)
                    live = t < lens_t
                    sub = {k: _where_rows(live, new[k], sub[k],
                                          self._banks[k].batch_axis)
                           for k in sub}
                    last_lg = torch.where((lens_t - 1 == t)[:, None],
                                          logits[:, -1].float(), last_lg)
            for k, t in sub.items():
                self.cache[k].index_copy_(self._banks[k].batch_axis, rows,
                                          t)
            del sub
            first = self._start_rows(pairs, rows, last_lg, lens_t)
        self.counts["prefill_steps"] += L
        host = first.cpu()
        now = time.perf_counter()
        self._trace_prefill(P, n, t_launch, now)
        self._seat(pairs, host, sum(lens), now)
        return n

    def _start_rows(self, pairs, rows: torch.Tensor, last_lg: torch.Tensor,
                    lens_t: torch.Tensor) -> torch.Tensor:
        """Sample each admitted row's first token from the logits of its
        last prompt position (``last_lg`` (n, V), rows in ``pairs`` order),
        then write the admitted slots ``rows`` of the slot state.  Returns
        (3, n) int32 on the device: first tokens, done-at-prefill flags,
        finite-logit flags (the caller's one host sync brings it back)."""
        dev = self.device
        max_new = torch.tensor([r.max_new_tokens - len(r.output)
                                for _, r in pairs],
                               dtype=torch.int32, device=dev)
        temps = torch.tensor([r.temperature for _, r in pairs],
                             dtype=torch.float32, device=dev)
        ok0 = torch.isfinite(last_lg).all(dim=-1)
        t0 = self._sample(last_lg, temps)
        done0 = (max_new - 1 <= 0) | (lens_t >= self.max_len)
        if self.eos_id is not None:
            done0 = done0 | (t0 == self.eos_id)
        st = self._state
        st["last"][rows] = t0
        st["pos"][rows] = lens_t
        # a row the health check will quarantine starts inactive; without
        # the check it decodes on, as the JAX engine's does
        st["active"][rows] = (ok0 & ~done0) if self.health_check else ~done0
        st["remaining"][rows] = max_new - 1
        st["temps"][rows] = temps
        self.counts["prefill_calls"] += 1
        return torch.stack([t0.to(torch.int32), done0.to(torch.int32),
                            ok0.to(torch.int32)])

    def _trace_prefill(self, P: int, n: int, t_launch: float,
                       now: float) -> None:
        if self.tracer is not None:
            self.tracer.span(f"prefill P={P}", "prefill", t_launch, now,
                             args={"tick": self.ticks, "admitted": n,
                                   "padded_len": P})

    def _seat(self, pairs, host: torch.Tensor, prefilled: int, now: float,
              on_ok=None) -> None:
        """Seat the admitted requests (the prefill's first tokens in
        ``host``, observed at ``now``) after charging ``prefilled`` tokens
        to the tick clock when ``charge_prefill_ticks``.  A row whose
        logits were not finite is quarantined (its first token dropped);
        ``on_ok(i)`` runs for every other row before a row done at prefill
        frees its slot."""
        if self.charge_prefill_ticks:
            self.ticks += -(-prefilled // self.slots)
        bad0: Dict[int, int] = {}
        for i, (s, r) in enumerate(pairs):
            self.slot_req[s] = r
            r._mark_admitted(self.ticks, now)
            if self.health_check and not host[2, i]:
                bad0[s] = 0
                continue
            r.output.append(int(host[0, i]))
            if on_ok is not None:
                on_ok(i)
            if host[1, i]:
                r._mark_done(self.ticks, now)
                self._release_slot(s)
        self._last_admitted = len(pairs)
        self._after_seat()
        if bad0:
            self._quarantine(bad0, now)

    def _after_seat(self) -> None:
        """Hook after admission seated its requests, before any of them is
        quarantined (PagedEngine closes its ``admit`` trace span)."""

    # ---- resilience -----------------------------------------------------
    def _fire_faults(self, site: str) -> None:
        """Chaos hook: let the attached FaultPlan act at a named site."""
        if self.fault_plan is not None:
            self.fault_plan.on_site(site, self)

    def _deactivate_slots(self, slots) -> None:
        """Clear the device active flag of ``slots`` (quarantine,
        preemption, mid-decode timeout); other rows keep theirs.  Their
        last token becomes 0: a free row still decodes it every tick, and
        a token the health check rejected as out of vocabulary must not
        reach the embedding."""
        idx = torch.tensor(sorted(slots), device=self.device)
        self._state["active"][idx] = False
        self._state["last"][idx] = 0

    def _stash_prefix(self, s: int, req: Request) -> None:
        """Hook before a preempted slot frees (PagedEngine puts the
        written prefix into the radix tree, so that the request re-admits
        cheaply)."""

    def _after_quarantine(self, n: int) -> None:
        """Hook after ``n`` slots were quarantined (PagedEngine flushes the
        radix tree and zeroes the free pages)."""

    def preempt_slot(self, s: int) -> Request:
        """Put the request in slot ``s`` back at the FRONT of the queue and
        free the slot.  It resumes from ``prompt + output`` on
        re-admission, so no emitted token is lost."""
        r = self.slot_req[s]
        if r is None:
            raise ValueError(f"slot {s} is not occupied")
        self._stash_prefix(s, r)
        self._deactivate_slots([s])
        self._release_slot(s)
        r.preemptions += 1
        self._rstats["preempted"] += 1
        r.state = QUEUED
        self._queue.appendleft(r)
        return r

    def resilience_stats(self) -> dict:
        """Terminal-state, retry and watchdog counters since reset."""
        return dict(self._rstats, degraded=self._degraded)

    def _launch_window(self, poison: Optional[torch.Tensor]):
        """Run the decode window behind the watchdog's launch gate.  The
        gate (the ``window_launch`` fault site) is retried with backoff and
        then degrades, sticky, counting ``window_fallbacks``; the window
        runs once after it, on the same kernels either way.  Only the gate
        is retried: it runs before anything touches the device, while an
        error inside the window (whose fused kernels write the cache in
        the launch) propagates out of ``step()``."""
        if not self._degraded:
            def gate():
                self._fire_faults("window_launch")

            def fallback():
                self._rstats["window_fallbacks"] += 1
                self._degraded = True

            def on_retry(attempt, err):
                self._rstats["window_retries"] += 1

            self.watchdog.call(gate, fallback=fallback,
                               label="decode_window", on_retry=on_retry)
        return self._window(poison)

    def _quarantine(self, bad: dict, now: float) -> None:
        """Requeue (or fail) the slots whose output flunked the health
        check.  Their tokens from the bad tick on were dropped by the
        drain, so each request's ``output`` is a clean prefix that the
        retry prefills again."""
        hit = []
        for s in sorted(bad):
            r = self.slot_req[s]
            if r is None:     # finished on a tick before the fault
                continue
            hit.append(s)
            self._rstats["quarantined"] += 1
            self._release_slot(s)
            r.retries += 1
            if r.retries > self.shed_policy.max_retries:
                r._finalize(
                    FAILED, self.ticks, now,
                    reason=(f"window health check failed {r.retries} "
                            "times (retry budget exhausted)"))
                self._rstats["failed"] += 1
            else:
                self._rstats["retried"] += 1
                r.state = QUEUED
                self._queue.appendleft(r)
        if hit:
            self._deactivate_slots(hit)
            self._after_quarantine(len(hit))

    def _expire_running(self, now: float) -> None:
        """Mid-decode deadlines: free the slots whose request ran past its
        deadline, keeping the partial output."""
        if not self.shed_policy.enforce_deadlines:
            return
        hit = []
        for s, r in enumerate(self.slot_req):
            if r is None or r.deadline is None or self.ticks <= r.deadline:
                continue
            hit.append(s)
            self._release_slot(s)
            r._finalize(
                TIMED_OUT, self.ticks, now,
                reason=(f"deadline {r.deadline:g} expired mid-decode at "
                        f"tick {self.ticks}"))
            self._rstats["timed_out"] += 1
        if hit:
            self._deactivate_slots(hit)

    # ---- engine loop ----------------------------------------------------
    def step(self) -> int:
        """One sync window: admit + K decode ticks + drain.  Returns the
        number of sequences active during the window."""
        self._fire_faults("pre_admit")
        self._admit()
        n_active = sum(r is not None for r in self.slot_req)
        if n_active == 0:
            return 0
        self._pre_window()
        self._fire_faults("pre_window")
        # the poison operand goes up before the window (a copy, not a
        # view of the host buffer, which is cleared below); without a
        # fault plan the window has no poison op at all
        poison = (torch.tensor(self._poison_host, device=self.device)
                  if self.fault_plan is not None else None)
        t_launch = time.perf_counter()
        out = self._launch_window(poison)
        if self._poison_host.any():
            self._poison_host[:] = False     # chaos poison is one-shot
        toks, fins, oks = out.cpu().numpy()     # ONE host sync
        now = time.perf_counter()
        self.counts["decode_ticks"] += self.ticks_per_sync
        # health check: the first tick per slot whose token is not to be
        # trusted (non-finite logits or an out-of-vocab sample)
        bad: Dict[int, int] = {}
        if self.health_check:
            for s in range(self.slots):
                if self.slot_req[s] is None:
                    continue
                for t in range(self.ticks_per_sync):
                    if toks[t, s] < 0:
                        continue
                    if not oks[t, s] or toks[t, s] >= self._vocab:
                        bad[s] = t
                        break
        for t in range(self.ticks_per_sync):
            for s in range(self.slots):
                r = self.slot_req[s]
                if r is None or toks[t, s] < 0:
                    continue
                if s in bad and t >= bad[s]:
                    continue     # drop everything from the bad tick on
                r.output.append(int(toks[t, s]))
                if fins[t, s]:
                    r._mark_done(self.ticks + t, now)
                    self._release_slot(s)
        if self.tracer is not None:
            t_end = time.perf_counter()
            self.tracer.span(
                "decode_window", "decode", t_launch, now,
                args={"tick": self.ticks, "K": self.ticks_per_sync,
                      "active": n_active})
            self.tracer.span("host_drain", "host", now, t_end,
                             args={"tick": self.ticks})
            self.tracer.counter("active_slots", {"active": n_active},
                                t_launch)
        self.ticks += self.ticks_per_sync
        if bad:
            self._quarantine(bad, now)
        self._expire_running(now)
        return n_active

    def run(self, max_ticks: int = 10_000) -> int:
        """Run to completion within a K-granular tick budget; returns the
        number of unfinished requests (0 when everything completed)."""
        return _drain_until_done(self, max_ticks)

    # ---- serve-mode NVM verdicts ---------------------------------------
    def serve_records(self, mesh: Optional[str] = None) -> List[dict]:
        """Dry-run-shaped records of the engine's counted traffic: one
        record per serve phase with PER-TICK (decode) / PER-CALL (prefill)
        roofline terms, consumable by ``core.crosslayer.analyze_serve``
        (the record keys and shape names of the JAX engine's)."""
        mesh = mesh or "1dev"
        arch = self.model.cfg.arch
        fam = self.model.cfg.family

        # recurrent banks are rewritten in full every tick, where KV decode
        # appends one row and reads the rest: ssm/hybrid records carry
        # their own read/write split
        extra: dict = {"family": fam}
        if fam in ("ssm", "hybrid"):
            extra["read_fraction"] = RECURRENT_READ_FRACTION

        recs = []
        stats = self._traffic["decode"]
        if stats is not None and self.counts["decode_ticks"]:
            recs.append({
                "arch": arch, "mesh": mesh, "kind": "decode",
                "shape": f"serve_{fam}_decode_b{self.slots}_l{self.max_len}",
                "attn_impl": self.attn_impl,
                "ticks": self.counts["decode_ticks"],
                "roofline": Roofline.from_stats(stats).terms(
                    self.ticks_per_sync), **extra})
        for P, stats in sorted(self._traffic["prefill"].items()):
            calls = self.counts["prefill_calls_by_len"].get(P, 0)
            if not calls:
                continue
            recs.append({
                "arch": arch, "mesh": mesh, "kind": "prefill",
                "shape": f"serve_{fam}_prefill_p{P}_b{self.slots}",
                "calls": calls,
                "roofline": Roofline.from_stats(stats).terms(), **extra})
        return recs

    def nvm_verdicts(self, tier_mb: Optional[float] = None):
        """SRAM/STT/SOT tier verdicts on the engine's counted traffic."""
        kw = {} if tier_mb is None else {"tier_mb": tier_mb}
        return analyze_serve(self.serve_records(), device=self.device, **kw)


class PagedEngine(Engine):
    """Paged-KV continuous-batching engine with radix-tree prefix sharing
    (torch counterpart of ``repro/serve/engine.py::PagedEngine``).

    Device KV lives in per-layer physical page pools of shape
    ``(num_pages + 1, page_size, K, hd)`` — the trailing page is TRASH,
    the scatter sink for masked and inactive rows — and every slot owns a
    row of one ``(slots, nb)`` int32 page table (``nb = max_len //
    page_size``).  Host-side bookkeeping is ``serve/paged.py``: a
    refcounted ``PagePool`` and a ``RadixTree`` of served prompts pinning
    the pages that hold their KV.

    Admission walks the tree for the longest stored prefix of each prompt
    (capped at ``len(prompt) - 1``, so that at least one suffix token
    prefills and gives the first token's logits), maps the shared full
    pages by bumping refcounts, copies the boundary page when the suffix
    starts mid-page (copy-on-write: a live row's boundary page is always
    private), and reserves the slot's whole page span
    ``ceil(min(L + max_new, max_len) / page_size)`` up front, so decode
    never allocates.  Only the unshared suffixes run through the model, in
    one batched paged prefill on the plain path; served prompts go into
    the tree.  When the pool runs short, LRU tree leaves are evicted; if
    it is still short the request steps aside (keeping its place in the
    queue) and is shed after ``shed_policy.max_defers`` defers.  A
    requeued request plans against ``prompt + output``; a preempted one
    first puts its written KV into the tree, so that it re-admits by
    prefilling one token.  A quarantine flushes the tree (shared KV may be
    what was corrupt) and zeroes every free page on the device.

    Decode runs ``Engine``'s window with the page table as an extra
    operand, uploaded before the window: ``attn_impl="kernel"`` calls the
    CUDA paged kernel (``kernels/ops.py::paged_decode_attention_fused``),
    ``"plain"`` scatters and gathers through the table (its oracle).
    Greedy outputs equal ``Engine``'s and ``EngineReference``'s on the same
    requests.
    """

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 page_size: int = 8, num_pages: Optional[int] = None, **kw):
        if "paged" not in model.serve_modes:
            raise UnsupportedFamilyError(
                model.cfg.family, serve_families("paged"), "PagedEngine",
                detail="pages hold positioned KV rows of a decoder")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size != 0:
            raise ValueError(
                f"max_len {max_len} must be a multiple of page_size "
                f"{page_size}")
        self.page_size = int(page_size)
        self.nb = max_len // self.page_size
        # default pool = dense capacity (slots x nb); prefix sharing then
        # lowers pages in use.  TRASH is the extra device page at index
        # num_pages, never managed by the host pool.
        self.num_pages = int(num_pages) if num_pages is not None \
            else slots * self.nb
        if self.num_pages < self.nb:
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold one full-length "
                f"request ({self.nb} pages)")
        self.trash = self.num_pages
        super().__init__(model, params, slots=slots, max_len=max_len, **kw)

    # ---- state ----------------------------------------------------------
    def _fresh_cache(self):
        return self.model.init_paged_cache(self.num_pages + 1,
                                           self.page_size)

    def reset(self) -> None:
        super().reset()
        self.pool = PagePool(self.num_pages, self.page_size)
        self.tree = RadixTree(self.pool)
        self._slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        self._pt_host = np.full((self.slots, self.nb), self.trash, np.int32)
        self._upload_page_table()
        self.stats = {"prefix_hits": 0, "prefix_tokens": 0,
                      "prompt_tokens": 0, "cow_copies": 0, "deferred": 0,
                      "evicted_pages": 0, "inserted_nodes": 0,
                      "tree_flushes": 0}
        self._last_shortage = (0, 0)   # (pages wanted, pages free)
        self._upf_sum = 0.0
        self._upf_windows = 0

    def paged_stats(self) -> dict:
        """Counters and pool gauges for launch printouts and the smoke."""
        pt = max(1, self.stats["prompt_tokens"])
        return {**self.stats,
                "pages_hwm": self.pool.hwm,
                "pages_in_use": self.pool.in_use,
                "free_pages": self.pool.free_pages,
                "radix_nodes": self.tree.num_nodes,
                "prefix_hit_rate": self.stats["prefix_tokens"] / pt}

    # ---- window plumbing -------------------------------------------------
    def _upload_page_table(self) -> None:
        """Copy the host page table to the device (a copy, never a view of
        the numpy buffer, on the CPU too)."""
        self._pt_dev = torch.tensor(self._pt_host, device=self.device)
        self._pt_dirty = False

    def _decode_kwargs(self) -> dict:
        return {"page_table": self._pt_dev}

    def _pre_window(self) -> None:
        if self._pt_dirty:
            self._upload_page_table()
        if not self.record_traffic and self.tracer is None:
            return
        # unique-page fraction of this window's decode reads: row b at
        # position p reads its first ceil((p+1)/ps) mapped pages
        mapped: List[int] = []
        for s, r in enumerate(self.slot_req):
            if r is None:
                continue
            pos = len(r.prompt) + len(r.output) - 1
            n = pages_for(min(pos + 1, self.max_len), self.page_size)
            mapped.extend(self._pt_host[s, :n].tolist())
        if mapped:
            frac = len(set(mapped)) / len(mapped)
            self._upf_sum += frac
            self._upf_windows += 1
            if self.tracer is not None:
                self.tracer.instant(
                    "page_gather", "paged", time.perf_counter(),
                    args={"tick": self.ticks, "mapped": len(mapped),
                          "unique": len(set(mapped)),
                          "unique_page_fraction": frac})

    def _release_slot(self, s: int) -> None:
        super()._release_slot(s)
        for p in self._slot_pages[s]:
            self.pool.release(p)
        self._slot_pages[s] = []
        self._pt_host[s] = self.trash
        self._pt_dirty = True

    def _copy_pages(self, src, dst) -> None:
        """Copy pages ``src`` onto pages ``dst`` in every pool, on the
        device, counting them in ``cow_copies``: admission's copy-on-write
        boundary pages and a ``cow_storm`` fault's copies both come here."""
        self.stats["cow_copies"] += len(dst)
        self.pool.cow_copies += len(dst)
        src = torch.tensor(list(src), device=self.device)
        dst = torch.tensor(list(dst), device=self.device)
        for pool in self.cache.values():
            pool[:, dst] = pool[:, src]

    # ---- resilience -----------------------------------------------------
    def _stash_prefix(self, s: int, req: Request) -> None:
        """Preemption keeps the work: the slot's written KV, positions
        ``[0, L + len(output) - 1)`` of the effective prompt (the last
        token is not written yet), goes into the radix tree under its
        tokens, so that re-admission prefills one suffix token."""
        written = len(req.prompt) + len(req.output) - 1
        if written < 1:
            return
        toks = (list(req.prompt) + list(req.output))[:written]
        self.stats["inserted_nodes"] += self.tree.insert(
            toks, self._slot_pages[s][:pages_for(written, self.page_size)])

    def _after_quarantine(self, n: int) -> None:
        # some KV is not to be trusted, and shared prefix pages could
        # poison every retry: flush the tree, then zero the pages it freed
        # (a recycled page is only partly overwritten by its next prefill,
        # and residue past the new occupant's length must not leak)
        self.stats["tree_flushes"] += 1
        self.tree.clear()
        free = sorted(self.pool._free)
        if free:
            idx = torch.tensor(free, device=self.device)
            for pool in self.cache.values():
                pool[:, idx] = 0

    # ---- admission ------------------------------------------------------
    def _plan(self, req: Request) -> Optional[dict]:
        """Reserve every page request ``req`` will ever touch, sharing
        tree-held prefix pages; a requeued request plans against its
        effective prompt ``prompt + output``.  Returns None (nothing
        mutated net) when the pool stays short even after LRU eviction;
        the shortfall is kept in ``_last_shortage`` for the shed reason."""
        ps = self.page_size
        prompt = list(req.prompt) + list(req.output)
        L = len(prompt)
        remaining = req.max_new_tokens - len(req.output)
        # cap the match one token short of the prompt: the suffix must be
        # non-empty so the admission prefill computes t0 logits
        matched, shared = self.tree.match(prompt[:L - 1])
        n_full = matched // ps
        boundary = matched % ps != 0
        held = shared[:n_full + (1 if boundary else 0)]
        for p in held:            # pin before eviction can free them
            self.pool.share(p)
        total = pages_for(min(L + remaining, self.max_len), ps)
        need = total - n_full     # the boundary page is copied: it is new
        if self.pool.free_pages < need:
            self.stats["evicted_pages"] += self.tree.evict(need)
        try:
            new = self.pool.alloc(need)
        except PagePoolExhausted as e:
            for p in held:        # roll back the pins; admission defers
                self.pool.release(p)
            self._last_shortage = (e.requested, e.free)
            return None
        self.stats["prompt_tokens"] += L
        self.stats["prefix_tokens"] += matched
        self.stats["prefix_hits"] += 1 if matched else 0
        cow = None
        if boundary:
            # suffix starts mid-page: a private copy of the shared boundary
            # page (new[0] covers logical page n_full); its pin is dropped
            # after the device copy in _admit
            cow = (held[n_full], new[0])
        return {"matched": matched, "L": L, "prompt": prompt, "cow": cow,
                "pages": shared[:n_full] + new, "total": total}

    def _admit(self) -> int:
        """Shed-or-defer admission, never head-of-line blocking: a request
        whose pages cannot be reserved steps aside (keeping its queue
        position) so that later requests that fit can run, and is shed
        once it has been passed over more than ``max_defers`` times.  The
        admitted requests' boundary pages are copied in one batched copy
        per pool, their page-table rows uploaded, and their suffixes
        prefilled in one batched paged prefill."""
        self._last_admitted = 0
        _drop_expired(self)
        free = [s for s in range(self.slots) if self.slot_req[s] is None]
        max_defers = self.shed_policy.max_defers
        pairs, plans = [], []
        deferred: List[Request] = []
        while free and self._queue:
            r = self._queue.popleft()
            plan = self._plan(r)
            if plan is None:
                self.stats["deferred"] += 1
                r.defers += 1
                if max_defers is not None and r.defers > max_defers:
                    want, have = self._last_shortage
                    r._finalize(
                        SHED, self.ticks, time.perf_counter(),
                        reason=(f"page pool exhausted on {r.defers} "
                                f"admission attempts (last shortfall: "
                                f"wanted {want} pages, {have} free)"))
                    self._rstats["shed"] += 1
                else:
                    deferred.append(r)
                continue
            pairs.append((free.pop(0), r))
            plans.append(plan)
        for r in reversed(deferred):
            self._queue.appendleft(r)
        if not pairs:
            return 0
        if self.tracer is not None:
            self.tracer.begin("admit", "prefill", time.perf_counter(),
                              args={"tick": self.ticks,
                                    "admitted": len(pairs)})
        cows = [p["cow"] for p in plans if p["cow"] is not None]
        if cows:
            self._copy_pages([c[0] for c in cows], [c[1] for c in cows])
            for c in cows:
                self.pool.release(c[0])
                if self.tracer is not None:
                    self.tracer.instant("cow_copy", "paged",
                                        time.perf_counter(),
                                        args={"src": int(c[0]),
                                              "dst": int(c[1])})
        for (s, _), p in zip(pairs, plans):
            self._slot_pages[s] = list(p["pages"])
            self._pt_host[s, :p["total"]] = p["pages"]   # the rest: TRASH
        self._upload_page_table()
        dev = self.device
        rows = torch.tensor([s for s, _ in pairs], device=dev)
        S = min(self.max_len,
                _next_pow2(max(p["L"] - p["matched"] for p in plans)))
        t_launch = time.perf_counter()
        with self._prefill_call(S):
            last_lg = self._prefill_prog(rows, plans, S)
            lens_t = torch.tensor([p["L"] for p in plans],
                                  dtype=torch.int32, device=dev)
            first = self._start_rows(pairs, rows, last_lg, lens_t)
        host = first.cpu()
        now = time.perf_counter()
        suffix = sum(p["L"] - p["matched"] for p in plans)
        if self.tracer is not None:
            self.tracer.span(
                f"prefill_chunk S={S}", "prefill", t_launch, now,
                args={"tick": self.ticks, "admitted": len(pairs),
                      "padded_len": S, "suffix_tokens": suffix,
                      "shared_tokens": sum(p["matched"] for p in plans)})

        def insert(i):
            # the tree takes its own references on the prompt's pages;
            # the slot may go on decoding into the boundary page at rows
            # >= L, which the tree never vouches for
            p = plans[i]
            self.stats["inserted_nodes"] += self.tree.insert(
                p["prompt"], p["pages"][:pages_for(p["L"], self.page_size)])

        self._seat(pairs, host, suffix, now, on_ok=insert)
        return len(pairs)

    def _after_seat(self) -> None:
        if self.tracer is not None:
            self.tracer.end(time.perf_counter(),
                            args={"pages_in_use": self.pool.in_use})

    # ---- serve-mode NVM verdicts ---------------------------------------
    def serve_records(self, mesh: Optional[str] = None) -> List[dict]:
        """Engine records plus the measured ``unique_page_fraction`` on the
        decode record (the mean over decode windows of the share of
        physically unique pages among the pages the rows read):
        ``analyze_serve`` scales KV-bound traffic by it, so the verdicts
        see prefix sharing's traffic reduction."""
        recs = super().serve_records(mesh)
        upf = (self._upf_sum / self._upf_windows
               if self._upf_windows else 1.0)
        for rec in recs:
            if rec["kind"] == "decode":
                rec["unique_page_fraction"] = upf
        return recs

    def _prefill_prog(self, rows: torch.Tensor, plans,
                      S: int) -> torch.Tensor:
        """Batched paged SUFFIX prefill of the admitted slots ``rows``: a
        decode-mode forward with ``S`` (the padded longest suffix) tokens
        per row starting at each row's matched prefix length, on the plain
        paged path.  Padding positions write to TRASH (``kv_write_mask``),
        so the shared prefix pages and the rows of other slots keep their
        bits.  Returns each row's logits at its last suffix token, (n, V)
        f32."""
        n = len(plans)
        tokens = np.zeros((n, S), np.int32)
        mask = np.zeros((n, S), bool)
        for i, p in enumerate(plans):
            suf = p["prompt"][p["matched"]:]
            tokens[i, :len(suf)] = suf
            mask[i, :len(suf)] = True
        dev = self.device
        starts = torch.tensor([p["matched"] for p in plans],
                              dtype=torch.int32, device=dev)
        last = torch.tensor([p["L"] - p["matched"] - 1 for p in plans],
                            device=dev)
        logits, _ = self.model.decode_step(
            self.params, self.cache,
            {"tokens": torch.from_numpy(tokens).to(dev)}, starts,
            attn_impl="plain", page_table=self._pt_dev[rows],
            kv_write_mask=torch.from_numpy(mask).to(dev), logits_at=last)
        return logits[:, 0]


class EngineReference:
    """The per-tick serving path, kept as the correctness oracle for
    ``Engine``: prompts prefill one token at a time through
    ``decode_step`` (on the admitted slot's row only), every decode tick
    brings the logits to the host, and sampling and termination run in
    Python.  Attention and sampling are always the plain versions; the
    encdec encoder alone is ``Engine``'s call (``_encode_rows``), so that
    both engines' ``enc/out`` rows are the same bits.  It
    takes the same ``shed_policy`` (backpressure, queued deadlines) and
    resumes a resubmitted request from ``prompt + output``."""

    ticks_per_sync = 1

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 eos_id: Optional[int] = None, seed: int = 0,
                 device: DeviceLike = None,
                 shed_policy: Optional[ShedPolicy] = None):
        self.device = _check_model(model, device, "EngineReference",
                                   max_len)
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.seed = seed
        self.shed_policy = shed_policy if shed_policy is not None \
            else ShedPolicy()
        self._banks, self._bank_reset, self._guarded = _bank_meta(
            model, slots, max_len)
        self.reset()

    def reset(self) -> None:
        self.cache = self.model.init_cache(self.slots, self.max_len)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self.slot_req: List[Optional[Request]] = [None] * self.slots
        self._queue: Deque[Request] = collections.deque()
        self._last = np.zeros(self.slots, np.int32)
        self._pos = np.zeros(self.slots, np.int32)
        self._active = np.zeros(self.slots, bool)
        self._remaining = np.zeros(self.slots, np.int32)
        self._temps = np.zeros(self.slots, np.float32)
        self.ticks = 0
        self._last_admitted = 0
        self._rstats = _new_rstats()

    def submit(self, req: Request) -> bool:
        """Same soft-fail semantics as ``Engine.submit``."""
        return _soft_submit(self, req)

    def resilience_stats(self) -> dict:
        return dict(self._rstats, degraded=False)

    def _admit(self) -> None:
        self._last_admitted = 0
        _drop_expired(self)
        for i in range(self.slots):
            if self.slot_req[i] is None and self._queue:
                self._prefill(i, self._queue.popleft())
                self._last_admitted += 1

    def _sample(self, logits_row: torch.Tensor, temp: float) -> int:
        if temp > 0:
            key = torch.randint(0, 2 ** 32, (2,), generator=self._gen,
                                device=self.device, dtype=torch.int64)
            temps = torch.tensor([temp], dtype=torch.float32,
                                 device=self.device)
            return int(fused_sample_plain(logits_row[None], temps, key)[0])
        return int(torch.argmax(logits_row))

    def _decode(self, cache, tokens: np.ndarray, pos: np.ndarray):
        """One plain decode step: (last-position logits, new cache)."""
        dev = self.device
        logits, new = self.model.decode_step(
            self.params, cache,
            {"tokens": torch.from_numpy(tokens[:, None]).to(dev)},
            torch.from_numpy(pos).to(dev), attn_impl="plain")
        return logits[:, -1], new

    def _prefill(self, slot: int, req: Request) -> None:
        """Per-token prefill of one slot's effective prompt ``prompt +
        output``, on that slot's cache row alone; the guarded banks' row
        is reset first (it still holds the previous occupant's state), and
        the encdec ``enc/out`` row is written by ``Engine``'s fixed-shape
        encoder call."""
        self.slot_req[slot] = req
        eff = list(req.prompt) + list(req.output)
        if self._guarded:
            _reset_rows(self.cache, slot, self._banks, self._bank_reset)
        if self.model.cfg.family == "encdec":
            _encode_rows(self, [slot], [eff])
        row = {n: c.narrow(self._banks[n].batch_axis, slot, 1)
               for n, c in self.cache.items()}
        lg = None
        for t, tok in enumerate(eff):
            lg, new = self._decode(row, np.array([tok], np.int32),
                                   np.array([t], np.int32))
            for n, c in new.items():
                if c is not row[n]:       # the recurrent banks' new state
                    row[n].copy_(c)
        t0 = self._sample(lg[0], req.temperature)
        req._mark_admitted(self.ticks, time.perf_counter())
        req.output.append(t0)
        self._last[slot] = t0
        self._pos[slot] = len(eff)
        self._remaining[slot] = req.max_new_tokens - len(req.output)
        self._temps[slot] = req.temperature
        done = (self._remaining[slot] <= 0
                or (self.eos_id is not None and t0 == self.eos_id)
                or self._pos[slot] >= self.max_len)
        if done:
            req._mark_done(self.ticks, time.perf_counter())
            self.slot_req[slot] = None
        self._active[slot] = not done

    def step(self) -> int:
        """One engine tick: admit + one batched decode + host sampling."""
        self._admit()
        active = np.nonzero(self._active)[0]
        if len(active) == 0:
            return 0
        lg, self.cache = self._decode(self.cache, self._last,
                                      np.clip(self._pos, 0, self.max_len - 1))
        lg = lg.cpu()
        for s in active:
            r = self.slot_req[s]
            tok = self._sample(lg[s].to(self.device), self._temps[s])
            r.output.append(tok)
            self._last[s] = tok
            self._pos[s] += 1
            self._remaining[s] -= 1
            done = (self._remaining[s] <= 0
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self._pos[s] >= self.max_len)
            if done:
                r._mark_done(self.ticks, time.perf_counter())
                self.slot_req[s] = None
                self._active[s] = False
        self.ticks += 1
        return len(active)

    def run(self, max_ticks: int = 10_000) -> int:
        return _drain_until_done(self, max_ticks)


# the per-tick oracle under the *_reference name of the sweep, cachesim and
# traffic engines, as the JAX package exports it
engine_reference = EngineReference
