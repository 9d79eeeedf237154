"""Device-resident continuous-batching serve engine (torch counterpart of
``Engine`` / ``EngineReference`` of ``repro/serve/engine.py`` for the
dense, ssm and hybrid families).

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
are position-guarded.  The GUARDED banks (``"recurrent"``, ``"ring"``)
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
                                          ShedPolicy, check_request)

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
    """
    uid: int
    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    done_tick: Optional[int] = None
    submit_tick: Optional[int] = None
    submit_time: Optional[float] = None
    admit_tick: Optional[int] = None
    admit_time: Optional[float] = None
    first_token_tick: Optional[int] = None
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None
    state: str = PENDING
    reason: Optional[str] = None      # why FAILED or SHED
    defers: int = 0                   # pool-exhausted admission defers

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def _mark_admitted(self, tick: int, now: float) -> None:
        self.state = RUNNING
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
    """Queue ``req``; a malformed request ends FAILED with the validation
    message as its reason instead of raising.  Returns True iff queued."""
    now = time.perf_counter()
    try:
        check_request(req, engine.max_len)
    except ValueError as e:
        req._finalize(FAILED, engine.ticks, now, reason=str(e))
        return False
    req.submit_tick = engine.ticks
    req.submit_time = now
    req.state = QUEUED
    engine._queue.append(req)
    return True


def _drain_until_done(engine, max_ticks: int) -> int:
    """Step until queue and slots are empty or the tick budget is spent.
    A window runs only if all its ``ticks_per_sync`` ticks fit in
    ``max_ticks``.  Returns the number of unfinished requests."""
    start = engine.ticks
    k = engine.ticks_per_sync
    while engine._queue or any(r is not None for r in engine.slot_req):
        if engine.ticks - start + k > max_ticks:
            break
        if engine.step() == 0 and not engine._queue:
            break
    return len(engine._queue) + sum(r is not None for r in engine.slot_req)


def _check_model(model: Model, device: DeviceLike, name: str):
    if "dense" not in model.serve_modes:
        raise UnsupportedFamilyError(model.cfg.family,
                                     serve_families("dense"), name)
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"{name} on {dev} but the model is on "
                         f"{model.device}")
    return model.device


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
    """

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 eos_id: Optional[int] = None, seed: int = 0,
                 ticks_per_sync: int = 8, attn_impl: str = "kernel",
                 sample_impl: str = "kernel", record_traffic: bool = True,
                 device: DeviceLike = None):
        self.device = _check_model(model, device, "Engine")
        if attn_impl not in IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {IMPLS}")
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
        self.sample_impl = sample_impl
        self.record_traffic = bool(record_traffic)
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
                       "prefill_steps": 0, "nonfinite_rows": 0,
                       "prefill_calls_by_len": {}}

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

    def _window(self):
        """K decode ticks, no host sync.  Returns (3, K, slots) int32:
        emitted tokens (-1 for inactive rows), finish flags, finite-logit
        flags.  The first window is counted (``_counted``)."""
        with self._counted():
            return self._ticks()

    def _ticks(self):
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
        """Queue a request; never raises (malformed requests end FAILED).
        Returns True iff queued."""
        return _soft_submit(self, req)

    def _admit(self) -> int:
        """Admit queued requests into free slots with one batched prefill
        (the masked per-token scan for the guarded families)."""
        free = [i for i in range(self.slots) if self.slot_req[i] is None]
        take = min(len(free), len(self._queue))
        if take == 0:
            return 0
        pairs = [(free[i], self._queue.popleft()) for i in range(take)]
        if self._guarded:
            return self._prefill_scan(pairs)
        P = min(self.max_len,
                _next_pow2(max(len(r.prompt) for _, r in pairs)))
        tokens = np.zeros((take, P), np.int32)
        lens = np.zeros(take, np.int32)
        for i, (_, r) in enumerate(pairs):
            tokens[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        dev = self.device
        rows = torch.tensor([s for s, _ in pairs], device=dev)
        lens_t = torch.from_numpy(lens).to(dev)
        with self._prefill_call(P):
            logits, fresh = self.model.prefill(
                self.params, {"tokens": torch.from_numpy(tokens).to(dev)},
                logits_at=(lens_t - 1).clamp(0, P - 1))
            valid = (torch.arange(P, device=dev)[None, :] < lens_t[:, None])
            for name in self.cache:
                self._scatter_bank(name, fresh[name], rows, valid)
            del fresh
            first = self._start_rows(pairs, rows, logits[:, 0], lens_t)
        self._land(pairs, first.cpu())
        return take

    def _prefill_scan(self, pairs) -> int:
        """Masked per-token prefill of the admitted slots, for the families
        whose guarded banks cannot take a scattered full-sequence cache.
        The admitted rows start from the banks' reset values; each prompt
        position runs one decode step on those rows alone, and its result
        merges only into rows still inside their prompt (``t < len``), so
        each admitted row ends in the state the reference engine's
        per-token loop leaves.  The rows go back into their slots at the
        end; no other slot's rows are read or written.  Runs ``max(len)``
        steps (the JAX engine runs to the power-of-two pad, whose extra
        steps merge nothing; the traffic is keyed by that pad)."""
        dev = self.device
        n = len(pairs)
        lens = [len(r.prompt) for _, r in pairs]
        L = max(lens)
        tokens = np.zeros((n, L), np.int32)
        for i, (_, r) in enumerate(pairs):
            tokens[i, :lens[i]] = r.prompt
        tok = torch.from_numpy(tokens).to(dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        rows = torch.tensor([s for s, _ in pairs], device=dev)
        with self._prefill_call(min(self.max_len, _next_pow2(L))):
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
        self._land(pairs, first.cpu())
        return n

    def _start_rows(self, pairs, rows: torch.Tensor, last_lg: torch.Tensor,
                    lens_t: torch.Tensor) -> torch.Tensor:
        """Sample each admitted row's first token from the logits of its
        last prompt position (``last_lg`` (n, V), rows in ``pairs`` order),
        then write the admitted slots ``rows`` of the slot state.  Returns
        (3, n) int32 on the device: first tokens, done-at-prefill flags,
        finite-logit flags (the caller's one host sync brings it back)."""
        dev = self.device
        max_new = torch.tensor([r.max_new_tokens for _, r in pairs],
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
        st["active"][rows] = ok0 & ~done0
        st["remaining"][rows] = max_new - 1
        st["temps"][rows] = temps
        self.counts["prefill_calls"] += 1
        return torch.stack([t0.to(torch.int32), done0.to(torch.int32),
                            ok0.to(torch.int32)])

    def _land(self, pairs, host: torch.Tensor) -> None:
        """Seat the admitted requests and record their first tokens; a row
        with non-finite logits fails, a row done at prefill frees its
        slot."""
        now = time.perf_counter()
        for i, (s, r) in enumerate(pairs):
            self.slot_req[s] = r
            r._mark_admitted(self.ticks, now)
            if not host[2, i]:
                self._fail(s, r, now, "non-finite logits at prefill")
                continue
            r.output.append(int(host[0, i]))
            if host[1, i]:
                r._mark_done(self.ticks, now)
                self._release_slot(s)

    def _fail(self, s: int, r: Request, now: float, why: str) -> None:
        self.counts["nonfinite_rows"] += 1
        r._finalize(FAILED, self.ticks, now, reason=why)
        self._release_slot(s)

    # ---- engine loop ----------------------------------------------------
    def step(self) -> int:
        """One sync window: admit + K decode ticks + drain.  Returns the
        number of sequences active during the window."""
        self._admit()
        n_active = sum(r is not None for r in self.slot_req)
        if n_active == 0:
            return 0
        self._pre_window()
        host = self._window().cpu().numpy()     # ONE host sync
        toks, fins, oks = host
        now = time.perf_counter()
        self.counts["decode_ticks"] += self.ticks_per_sync
        bad = []
        for t in range(self.ticks_per_sync):
            for s in range(self.slots):
                r = self.slot_req[s]
                if r is None or toks[t, s] < 0:
                    continue
                if not oks[t, s]:
                    self._fail(s, r, now, f"non-finite logits at tick "
                               f"{self.ticks + t}")
                    bad.append(s)
                    continue
                r.output.append(int(toks[t, s]))
                if fins[t, s]:
                    r._mark_done(self.ticks + t, now)
                    self._release_slot(s)
        if bad:
            self._state["active"][torch.tensor(bad, device=self.device)] \
                = False
        self.ticks += self.ticks_per_sync
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
    queue) and is shed after ``shed_policy.max_defers`` defers.

    Decode runs ``Engine``'s window with the page table as an extra
    operand, uploaded before the window: ``attn_impl="kernel"`` calls the
    CUDA paged kernel (``kernels/ops.py::paged_decode_attention_fused``),
    ``"plain"`` scatters and gathers through the table (its oracle).
    Greedy outputs equal ``Engine``'s and ``EngineReference``'s on the same
    requests.
    """

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 page_size: int = 8, num_pages: Optional[int] = None,
                 shed_policy: Optional[ShedPolicy] = None, **kw):
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
        self.shed_policy = shed_policy if shed_policy is not None \
            else ShedPolicy()
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
                      "evicted_pages": 0, "inserted_nodes": 0}
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
        if not self.record_traffic:
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
            self._upf_sum += len(set(mapped)) / len(mapped)
            self._upf_windows += 1

    def _release_slot(self, s: int) -> None:
        super()._release_slot(s)
        for p in self._slot_pages[s]:
            self.pool.release(p)
        self._slot_pages[s] = []
        self._pt_host[s] = self.trash
        self._pt_dirty = True

    # ---- admission ------------------------------------------------------
    def _plan(self, req: Request) -> Optional[dict]:
        """Reserve every page request ``req`` will ever touch, sharing
        tree-held prefix pages.  Returns None (nothing mutated net) when
        the pool stays short even after LRU eviction; the shortfall is
        kept in ``_last_shortage`` for the shed reason."""
        ps = self.page_size
        prompt = list(req.prompt)
        L = len(prompt)
        # cap the match one token short of the prompt: the suffix must be
        # non-empty so the admission prefill computes t0 logits
        matched, shared = self.tree.match(prompt[:L - 1])
        n_full = matched // ps
        boundary = matched % ps != 0
        held = shared[:n_full + (1 if boundary else 0)]
        for p in held:            # pin before eviction can free them
            self.pool.share(p)
        total = pages_for(min(L + req.max_new_tokens, self.max_len), ps)
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
            self.stats["cow_copies"] += 1
            self.pool.cow_copies += 1
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
                else:
                    deferred.append(r)
                continue
            pairs.append((free.pop(0), r))
            plans.append(plan)
        for r in reversed(deferred):
            self._queue.appendleft(r)
        if not pairs:
            return 0
        dev = self.device
        cows = [p["cow"] for p in plans if p["cow"] is not None]
        if cows:
            src = torch.tensor([c[0] for c in cows], device=dev)
            dst = torch.tensor([c[1] for c in cows], device=dev)
            for pool in self.cache.values():
                pool[:, dst] = pool[:, src]
            for c in cows:
                self.pool.release(c[0])
        for (s, _), p in zip(pairs, plans):
            self._slot_pages[s] = list(p["pages"])
            self._pt_host[s, :p["total"]] = p["pages"]   # the rest: TRASH
        self._upload_page_table()
        rows = torch.tensor([s for s, _ in pairs], device=dev)
        S = min(self.max_len,
                _next_pow2(max(p["L"] - p["matched"] for p in plans)))
        with self._prefill_call(S):
            last_lg = self._prefill_prog(rows, plans, S)
            lens_t = torch.tensor([p["L"] for p in plans],
                                  dtype=torch.int32, device=dev)
            first = self._start_rows(pairs, rows, last_lg, lens_t)
        host = first.cpu()
        for i, p in enumerate(plans):
            if host[2, i]:
                # the tree takes its own references on the prompt's pages;
                # the slot may go on decoding into the boundary page at
                # rows >= L, which the tree never vouches for
                self.stats["inserted_nodes"] += self.tree.insert(
                    p["prompt"],
                    p["pages"][:pages_for(p["L"], self.page_size)])
        self._land(pairs, host)
        return len(pairs)

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
    Python.  Attention and sampling are always the plain versions."""

    ticks_per_sync = 1

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 eos_id: Optional[int] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.device = _check_model(model, device, "EngineReference")
        self.model = model
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.seed = seed
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

    def submit(self, req: Request) -> bool:
        """Same soft-fail semantics as ``Engine.submit``."""
        return _soft_submit(self, req)

    def _admit(self) -> None:
        for i in range(self.slots):
            if self.slot_req[i] is None and self._queue:
                self._prefill(i, self._queue.popleft())

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
        """Per-token prefill of one slot, on that slot's cache row alone;
        the guarded banks' row is reset first (it still holds the previous
        occupant's state)."""
        self.slot_req[slot] = req
        if self._guarded:
            _reset_rows(self.cache, slot, self._banks, self._bank_reset)
        row = {n: c.narrow(self._banks[n].batch_axis, slot, 1)
               for n, c in self.cache.items()}
        lg = None
        for t, tok in enumerate(req.prompt):
            lg, new = self._decode(row, np.array([tok], np.int32),
                                   np.array([t], np.int32))
            for n, c in new.items():
                if c is not row[n]:       # the recurrent banks' new state
                    row[n].copy_(c)
        t0 = self._sample(lg[0], req.temperature)
        req._mark_admitted(self.ticks, time.perf_counter())
        req.output.append(t0)
        self._last[slot] = t0
        self._pos[slot] = len(req.prompt)
        self._remaining[slot] = req.max_new_tokens - 1
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
