"""The port's serve robustness layer (``repro_torch.serve.resilience``,
``serve.chaos`` and the engines' deadlines, backpressure, quarantine and
retry, preemption and watchdog) on the CPU, against the JAX package.

The cases of ``tests/test_resilience.py``, ``test_resilience_properties.py``
(seeded interleavings in place of hypothesis) and
``test_serve_engine.py``'s arrival and budget cases run on the port; then
the same ``FaultPlan``, seed and requests go through the JAX ``Engine`` /
``PagedEngine`` (the xla path) and the port's, which must give equal
outputs, terminal states, reasons, tick stamps, ``resilience_stats()`` and
``paged_stats()``.  Reduced llama3-8b (and reduced mamba2 for the guarded
banks) in f32, weights from ``model.init(PRNGKey(0))`` through
``models/convert.py``: resume from ``prompt + output`` is an f32 contract.
"""
import copy
import time
import types
from collections import Counter

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import (DONE, FAILED, QUEUED, SHED,  # noqa: E402
                               TERMINAL_STATES, TIMED_OUT, Engine,
                               EngineReference, Fault, FaultPlan,
                               InjectedFault, PagedEngine, Request,
                               ShedPolicy, Tracer, WatchdogError,
                               WindowWatchdog, latency_summary,
                               mixed_requests, poisson_requests,
                               run_arrivals, run_staggered,
                               shared_prefix_requests, staggered_groups,
                               validate_chrome_trace)

MAX_LEN = 48
SLOTS = 3


def _convert(arch, max_len):
    jcfg = jreduced(jget_config(arch), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=max_len)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch), dtype="float32")
    model = build_model(cfg, max_seq=max_len, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def both():
    return _convert("llama3-8b", MAX_LEN)


@pytest.fixture(scope="module")
def mp(both):
    return both[2], both[3]


@pytest.fixture(scope="module")
def dense(mp):
    model, params = mp
    return Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                  ticks_per_sync=2, record_traffic=False, device="cpu")


@pytest.fixture(scope="module")
def paged(mp):
    model, params = mp
    return PagedEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                       page_size=4, ticks_per_sync=2, record_traffic=False,
                       device="cpu")


@pytest.fixture(scope="module")
def tight(mp):
    """A page pool that fits ONE in-flight request: 8 pages of 4 tokens on
    2 slots, so a 20-token reservation starves the second slot."""
    model, params = mp
    return PagedEngine(model, params, slots=2, max_len=32, page_size=4,
                       num_pages=8, ticks_per_sync=2, record_traffic=False,
                       device="cpu")


@pytest.fixture(scope="module")
def ref(mp):
    model, params = mp
    return EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                           device="cpu")


def _fresh(eng, *, plan=None, policy=None, watchdog=None):
    eng.reset()
    eng.fault_plan = plan
    eng.shed_policy = policy if policy is not None else ShedPolicy()
    eng.watchdog = (watchdog if watchdog is not None
                    else WindowWatchdog(backoff_s=0.001))
    return eng


def _alone(ref, prompt, max_new):
    """Clean single-request reference output."""
    ref.reset()
    r = Request(uid=0, prompt=list(prompt), max_new_tokens=max_new)
    ref.submit(r)
    assert ref.run() == 0
    return list(r.output)


def _conserved(eng, plan=None):
    slot_refs = Counter()
    for s, r in enumerate(eng.slot_req):
        if r is not None:
            slot_refs.update(eng._slot_pages[s])
    held = plan.held_refs() if plan is not None else Counter()
    eng.pool.check(eng.tree.held_refs() + slot_refs + held)


# --- WindowWatchdog units ---------------------------------------------------


def test_watchdog_retries_then_succeeds():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    retries = []
    wd = WindowWatchdog(max_attempts=3, backoff_s=0.0)
    assert wd.call(flaky, on_retry=lambda a, e: retries.append(a)) == "ok"
    assert len(calls) == 3 and retries == [0, 1]


def test_watchdog_exhaustion_uses_fallback_then_raises_without():
    def broken():
        raise RuntimeError("permanent")

    wd = WindowWatchdog(max_attempts=2, backoff_s=0.0)
    assert wd.call(broken, fallback=lambda: "degraded") == "degraded"
    with pytest.raises(WatchdogError) as ei:
        wd.call(broken, label="win")
    assert "permanent" in str(ei.value.__cause__)


def test_watchdog_timeout_abandons_hung_attempt():
    def hung():
        time.sleep(5.0)
        return "never"

    wd = WindowWatchdog(max_attempts=1, backoff_s=0.0, timeout_s=0.05)
    t0 = time.perf_counter()
    assert wd.call(hung, fallback=lambda: "degraded") == "degraded"
    assert time.perf_counter() - t0 < 2.0
    # a fast attempt on the thread returns its value, an error re-raises
    wd = WindowWatchdog(max_attempts=1, backoff_s=0.0, timeout_s=2.0)
    assert wd.call(lambda: 7) == 7
    with pytest.raises(WatchdogError):
        wd.call(lambda: 1 / 0)


def test_watchdog_and_fault_validation():
    with pytest.raises(ValueError, match="max_attempts"):
        WindowWatchdog(max_attempts=0)
    with pytest.raises(ValueError, match="backoff"):
        WindowWatchdog(backoff_factor=0.5)
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor_strike")
    with pytest.raises(ValueError, match="at >= 0"):
        Fault("nan_logits", at=-1)
    assert ShedPolicy() == ShedPolicy(max_queue_depth=None,
                                      enforce_deadlines=True, max_retries=2,
                                      max_defers=None)


def test_resilience_module_matches_jax():
    """Terminal states, the chaos catalog and the policy defaults are the
    JAX package's."""
    assert tserve.TERMINAL_STATES == jserve.TERMINAL_STATES
    for name in ("DONE", "SHED", "TIMED_OUT", "FAILED", "PENDING", "QUEUED",
                 "RUNNING"):
        assert getattr(tserve, name) == getattr(jserve, name)
    from repro.serve import chaos as jchaos
    from repro_torch.serve import chaos as tchaos
    assert tchaos.SITES == jchaos.SITES
    assert tchaos.KIND_SITE == jchaos.KIND_SITE
    import dataclasses
    assert (dataclasses.asdict(tserve.ShedPolicy())
            == dataclasses.asdict(jserve.ShedPolicy()))
    assert (dataclasses.asdict(tserve.WindowWatchdog())
            == dataclasses.asdict(jserve.WindowWatchdog()))
    assert ([f.name for f in dataclasses.fields(tserve.Request)]
            == [f.name for f in dataclasses.fields(jserve.Request)])


# --- shed policy: backpressure + deadlines ----------------------------------


def test_queue_depth_backpressure_sheds(dense):
    _fresh(dense, policy=ShedPolicy(max_queue_depth=2))
    reqs = [Request(uid=i, prompt=[3 + i, 5], max_new_tokens=3)
            for i in range(4)]
    accepted = [dense.submit(r) for r in reqs]
    assert accepted == [True, True, False, False]
    assert reqs[2].state == SHED and "queue depth" in reqs[2].reason
    dense.run()
    assert reqs[0].state == DONE and reqs[1].state == DONE
    assert dense.resilience_stats()["shed"] == 2


@pytest.mark.parametrize("engine_fixture", ["dense", "paged", "ref"])
def test_expired_queued_deadline_times_out(engine_fixture, request):
    eng = request.getfixturevalue(engine_fixture)
    eng.reset()
    r = Request(uid=0, prompt=[5, 7], max_new_tokens=4, deadline=-1.0)
    assert eng.submit(r)          # queued fine; expiry is checked at admit
    eng.run()
    assert r.state == TIMED_OUT and r.output == []
    assert "expired in queue" in r.reason
    assert eng.resilience_stats()["timed_out"] == 1


def test_mid_decode_deadline_keeps_prefix(dense, ref):
    alone = _alone(ref, [5, 7, 11, 13], 20)
    _fresh(dense)
    r = Request(uid=0, prompt=[5, 7, 11, 13], max_new_tokens=20,
                deadline=5.0)
    dense.submit(r)
    dense.run()
    assert r.state == TIMED_OUT and "mid-decode" in r.reason
    assert 0 < len(r.output) < len(alone)
    assert r.output == alone[:len(r.output)]
    assert not dense._state["active"].any()


# --- tight pool: defer, deadline, max_defers shed ---------------------------


def test_tight_pool_defers_then_deadline_resolves(tight, ref):
    """One request's reservation starves the pool; the second defers (no
    head-of-line deadlock) and its deadline resolves it while the first
    finishes untouched."""
    alone = _alone(ref, list(range(2, 12)), 10)
    _fresh(tight)
    a = Request(uid=0, prompt=list(range(2, 12)), max_new_tokens=10)
    b = Request(uid=1, prompt=list(range(3, 13)), max_new_tokens=10,
                deadline=4.0)
    tight.submit(a)
    tight.submit(b)
    tight.run()
    assert a.state == DONE and list(a.output) == alone
    assert b.state in (TIMED_OUT, SHED)
    assert tight.paged_stats()["deferred"] > 0
    _conserved(tight)


def test_tight_pool_max_defers_sheds_with_shortfall_reason(tight):
    _fresh(tight, policy=ShedPolicy(max_defers=2))
    a = Request(uid=0, prompt=list(range(2, 12)), max_new_tokens=10)
    b = Request(uid=1, prompt=list(range(3, 13)), max_new_tokens=10)
    tight.submit(a)
    tight.submit(b)
    tight.run()
    assert a.state == DONE
    assert b.state == SHED
    assert "page pool exhausted" in b.reason and "pages" in b.reason
    assert tight.resilience_stats()["shed"] == 1
    _conserved(tight)


def test_held_pool_stall_advances_the_clock(tight):
    """A pool a fault holds for longer than the run: nothing admits, the
    run loop advances the tick clock instead of spinning, and the
    request's deadline ends it."""
    plan = FaultPlan([Fault("pool_exhaust", at=0, hold=1000)])
    _fresh(tight, plan=plan)
    r = Request(uid=0, prompt=[5, 7], max_new_tokens=4, deadline=6.0)
    tight.submit(r)
    assert tight.run(max_ticks=100) == 0
    assert r.state == TIMED_OUT and tight.ticks > 6
    _conserved(tight, plan)
    assert plan.release_held() == tight.num_pages


# --- preemption: resume is token for token ----------------------------------


@pytest.mark.parametrize("engine_fixture", ["dense", "paged"])
def test_preempt_mid_decode_resumes_token_for_token(engine_fixture, request,
                                                    ref):
    eng = _fresh(request.getfixturevalue(engine_fixture))
    alone = _alone(ref, [5, 7, 11, 13], 16)
    r = Request(uid=0, prompt=[5, 7, 11, 13], max_new_tokens=16)
    eng.submit(r)
    eng.step()
    slot = next(s for s, q in enumerate(eng.slot_req) if q is r)
    assert 0 < len(r.output) < 16     # genuinely mid-decode
    first = (r.admit_tick, r.submit_tick)
    eng.preempt_slot(slot)
    assert eng.slot_req[slot] is None and r.preemptions == 1
    assert r.state == QUEUED and eng._queue[0] is r
    eng.run()
    assert r.state == DONE and list(r.output) == alone
    assert (r.admit_tick, r.submit_tick) == first
    assert eng.resilience_stats()["preempted"] == 1
    if hasattr(eng, "pool"):
        # the stashed prefix is matched again, not prefilled again
        assert eng.paged_stats()["prefix_tokens"] > 0
        _conserved(eng)


def test_preempt_empty_slot_raises(dense):
    _fresh(dense)
    with pytest.raises(ValueError, match="not occupied"):
        dense.preempt_slot(0)


# --- health check: quarantine and retry -------------------------------------


def test_poisoned_row_is_retried_to_the_unfaulted_output(dense, ref):
    """One window poisons the request's row: the slot is quarantined, the
    tokens from the bad tick on are dropped, and the retry (from prompt +
    output) ends DONE with exactly the unfaulted answer."""
    alone = _alone(ref, [5, 7, 11], 9)
    plan = FaultPlan([Fault("nan_logits", at=1, slot=0)])
    _fresh(dense, plan=plan)
    r = Request(uid=0, prompt=[5, 7, 11], max_new_tokens=9)
    dense.submit(r)
    assert dense.run() == 0
    assert r.state == DONE and r.output == alone and r.retries == 1
    rs = dense.resilience_stats()
    assert rs["quarantined"] == rs["retried"] == 1 and rs["failed"] == 0
    assert plan.injected == Counter({"nan_logits": 1})
    assert not dense._poison_host.any()       # the poison is one-shot


def test_quarantine_retry_budget_exhaustion_fails(dense):
    """Every window poisons slot 0: with max_retries=1 the request is
    quarantined, retried once, quarantined again, and FAILED."""
    plan = FaultPlan([Fault("nan_logits", at=0, count=8, slot=0)], seed=0)
    _fresh(dense, plan=plan, policy=ShedPolicy(max_retries=1))
    r = Request(uid=0, prompt=[5, 7, 11], max_new_tokens=8)
    dense.submit(r)
    dense.run()
    assert r.state == FAILED
    assert "health check" in r.reason and "retry budget" in r.reason
    rs = dense.resilience_stats()
    assert rs["quarantined"] == 2 and rs["retried"] == 1
    assert rs["failed"] == 1 and r.retries == 2


def test_corrupt_shared_page_quarantines_every_sharer(paged, ref):
    """kv_corrupt on a slot's first page, which another running slot maps
    through the tree: both rows fail the window health check, one tree
    flush and page scrub follow, and both retries end with the unfaulted
    answers.  Then a NaN written into a page only the tree holds reaches
    the next sharer at its prefill: it is quarantined at admission and its
    retry ends with the unfaulted answer too."""
    template = list(range(100, 126))
    a = Request(uid=0, prompt=template + [7, 9], max_new_tokens=12)
    b = Request(uid=1, prompt=template + [3, 5], max_new_tokens=6)
    c = Request(uid=2, prompt=template + [8, 1, 4], max_new_tokens=5)
    want = {r.uid: _alone(ref, r.prompt, r.max_new_tokens)
            for r in (a, b, c)}
    plan = FaultPlan([Fault("kv_corrupt", at=1, slot=0)])
    _fresh(paged, plan=plan)
    paged.submit(a)
    paged.step()
    paged.submit(b)
    paged.step()                       # b shares a's first page: both NaN
    rs = paged.resilience_stats()
    assert rs["quarantined"] == rs["retried"] == 2
    assert paged.paged_stats()["tree_flushes"] == 1
    assert paged.run() == 0
    _, pages = paged.tree.match(template)
    for v in paged.cache.values():
        v[:, pages[0], :1] = float("nan")
    paged.submit(c)
    paged.step()
    assert c.retries == 1 and paged.paged_stats()["tree_flushes"] == 2
    assert paged.run() == 0
    for r in (a, b, c):
        assert r.state == DONE and r.output == want[r.uid]
    _conserved(paged, plan)


def test_out_of_vocab_sample_is_quarantined(dense, ref, monkeypatch):
    """The health check also drops an out-of-vocab token: a sampler that
    returns one once quarantines the row, and the retry ends with the
    unfaulted answer."""
    alone = _alone(ref, [9, 4, 2], 6)
    real = ops.fused_sample
    calls = []

    def bad_once(logits, temps, key):
        out = real(logits, temps, key)
        calls.append(1)
        if len(calls) == 3:              # a decode tick of the first window
            out = out.clone()
            out[0] = logits.shape[-1] + 5
        return out

    monkeypatch.setattr(ops, "fused_sample", bad_once)
    _fresh(dense)
    r = Request(uid=0, prompt=[9, 4, 2], max_new_tokens=6)
    dense.submit(r)
    dense.run()
    assert r.state == DONE and r.output == alone and r.retries == 1
    assert dense.resilience_stats()["quarantined"] == 1


def test_resubmitted_request_keeps_its_first_stamps(dense, ref):
    """A crash (reset) and a resubmit: the request keeps the submit and
    admission stamps of its first submit, and resumes token for token."""
    want = _alone(ref, [4, 8, 15, 16], 12)
    _fresh(dense)
    warm = Request(uid=9, prompt=[2, 3], max_new_tokens=6)
    dense.submit(warm)
    dense.run()
    assert dense.ticks > 0
    r = Request(uid=0, prompt=[4, 8, 15, 16], max_new_tokens=12)
    dense.submit(r)
    dense.step()
    stamps = (r.submit_tick, r.submit_time, r.admit_tick, r.admit_time)
    assert stamps[0] == r.admit_tick > 0 and r.output
    _fresh(dense)                      # the crash
    assert dense.submit(r)
    assert dense.run() == 0
    assert (r.submit_tick, r.submit_time, r.admit_tick,
            r.admit_time) == stamps
    assert r.state == DONE and r.output == want


def test_crash_rebuild_resumes_token_for_token(dense, ref):
    reqs = mixed_requests(5, seed=4, vocab=512, prompt_lens=(2, 9),
                          max_new=(6, 12))
    want = {r.uid: _alone(ref, r.prompt, r.max_new_tokens) for r in reqs}
    _fresh(dense)
    for r in reqs:
        dense.submit(r)
    dense.step()
    dense.step()
    survivors = [r for r in reqs if not r.terminal]
    assert survivors and any(r.output for r in survivors)
    _fresh(dense)
    for r in survivors:
        dense.submit(r)
    assert dense.run() == 0
    for r in reqs:
        assert r.state == DONE and list(r.output) == want[r.uid]


def test_reference_resumes_a_resubmitted_request(ref):
    want = _alone(ref, [6, 1, 8], 10)
    ref.reset()
    r = Request(uid=0, prompt=[6, 1, 8], max_new_tokens=10)
    ref.submit(r)
    for _ in range(4):
        ref.step()
    assert 0 < len(r.output) < 10
    ref.reset()
    ref.submit(r)
    assert ref.run() == 0 and r.output == want
    assert ref.resilience_stats() == dict(
        {k: 0 for k in ("failed", "shed", "timed_out", "quarantined",
                        "retried", "preempted", "window_retries",
                        "window_fallbacks")}, degraded=False)


# --- watchdog in the engine --------------------------------------------------


class _Calls:
    """Counts the kernel wrappers' calls and the plain versions' calls made
    from outside them, so that a test can show which path the engine took
    on CPU tensors."""

    def __init__(self, monkeypatch):
        from repro_torch.kernels import decode_attention as da
        from repro_torch.kernels import sampling as sm
        self.n = Counter()
        for mod, name in ((ops, "decode_attention_fused"),
                          (ops, "paged_decode_attention_fused"),
                          (ops, "fused_sample")):
            monkeypatch.setattr(mod, name, self._wrap(name,
                                                      getattr(mod, name)))
        self.inside = 0
        for mod, name in ((da, "decode_attention_fused_plain"),
                          (sm, "fused_sample_plain")):
            monkeypatch.setattr(mod, name, self._plain(name,
                                                       getattr(mod, name)))

    def _wrap(self, name, fn):
        def call(*a, **k):
            self.n[name] += 1
            self.inside += 1
            try:
                return fn(*a, **k)
            finally:
                self.inside -= 1
        return call

    def _plain(self, name, fn):
        def call(*a, **k):
            if not self.inside:
                self.n["plain outside a wrapper: " + name] += 1
            return fn(*a, **k)
        return call


@pytest.mark.parametrize("count,degraded", [(1, False), (3, True)])
def test_window_stall_retries_then_degrades_on_the_kernels(
        mp, ref, monkeypatch, count, degraded):
    """An injected stall at the launch gate is retried; three in a row
    exhaust the watchdog, which degrades (sticky).  Either way every
    window goes through the kernel wrappers: one decode launch per layer
    and tick, one sampler launch per tick and prefill, no plain path."""
    model, params = mp
    reqs = mixed_requests(4, seed=8, vocab=512, prompt_lens=(2, 7),
                          max_new=(4, 9))
    want = {r.uid: _alone(ref, r.prompt, r.max_new_tokens) for r in reqs}
    calls = _Calls(monkeypatch)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, record_traffic=False, device="cpu",
                 watchdog=WindowWatchdog(backoff_s=0.0),
                 fault_plan=FaultPlan([Fault("window_stall", at=0,
                                             count=count)]))
    assert run_staggered(eng, [copy.deepcopy(reqs)]) == want
    rs = eng.resilience_stats()
    assert rs["window_retries"] == count
    assert rs["window_fallbacks"] == int(degraded)
    assert rs["degraded"] is degraded
    assert eng.fault_plan.injected == Counter({"window_stall": count})
    ticks = eng.counts["decode_ticks"]
    assert calls.n == Counter({
        "decode_attention_fused": model.cfg.num_layers * ticks,
        "fused_sample": ticks + eng.counts["prefill_calls"]})


def test_error_inside_the_window_propagates(dense, monkeypatch):
    """Only the launch gate is retried: an error raised inside the window
    (after the kernels may have written the cache) leaves ``step()`` at
    once, with no retry and no fallback."""
    _fresh(dense, plan=FaultPlan([]))
    dense.submit(Request(uid=0, prompt=[3, 4, 5], max_new_tokens=6))
    dense._admit()
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("device fault inside the window")

    monkeypatch.setattr(ops, "decode_attention_fused", broken)
    with pytest.raises(RuntimeError, match="inside the window"):
        dense.step()
    assert len(calls) == 1
    rs = dense.resilience_stats()
    assert rs["window_retries"] == rs["window_fallbacks"] == 0
    assert rs["degraded"] is False


def test_clean_window_has_no_poison_op(dense):
    """Without a fault plan the window runs no poison operand, so its
    counted traffic is the plain engine's."""
    from repro_torch.launch.graph_analysis import OpCounter
    counts = []
    for plan in (None, FaultPlan([])):
        _fresh(dense, plan=plan)
        dense.submit(Request(uid=0, prompt=[3, 4, 5], max_new_tokens=6))
        dense._admit()
        poison = (torch.tensor(dense._poison_host)
                  if plan is not None else None)
        with OpCounter() as c:
            dense._window(poison)
        counts.append(c.stats)
    assert counts[0].kernel_calls == counts[1].kernel_calls
    assert counts[0].bytes < counts[1].bytes
    assert set(counts[0].bytes_by_op) <= set(counts[1].bytes_by_op)


# --- seeded chaos interleavings (the hypothesis property, fixed seeds) ------


FAULT_KINDS = ("nan_logits", "kv_corrupt", "pool_exhaust", "cow_storm",
               "window_stall")


@pytest.fixture(scope="module")
def chaos_engine():
    _, _, model, params = _convert("llama3-8b", 24)
    return PagedEngine(model, params, slots=2, max_len=24, page_size=4,
                       num_pages=8, ticks_per_sync=2, record_traffic=False,
                       device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_chaos_interleaving_conserves_refs_and_terminates(chaos_engine,
                                                          seed):
    """Random faults interleaved with admissions, steps and preemptions on
    a tight pool: page references are conserved at every step (pool ==
    tree + slots + the plan's stolen pages), the run terminates, and every
    request ends in exactly one terminal state."""
    rng = np.random.default_rng(seed)
    engine = chaos_engine
    faults = [Fault(kind=FAULT_KINDS[rng.integers(len(FAULT_KINDS))],
                    at=int(rng.integers(0, 5)), count=int(rng.integers(1, 3)),
                    pages=int(rng.integers(0, 4)),
                    hold=int(rng.integers(0, 3)))
              for _ in range(int(rng.integers(1, 4)))]
    plan = FaultPlan(faults, seed=int(rng.integers(0, 100)))
    engine.reset()
    engine.fault_plan = plan
    engine.shed_policy = ShedPolicy(max_defers=4, max_retries=2)
    engine.watchdog = WindowWatchdog(max_attempts=2, backoff_s=0.0)
    reqs = mixed_requests(int(rng.integers(2, 6)),
                          seed=int(rng.integers(0, 100)), vocab=512,
                          prompt_lens=(2, 8), max_new=(2, 8))
    deadline = [None, 20.0][int(rng.integers(2))]
    for r in reqs:
        r.deadline = deadline
        engine.submit(r)
        _conserved(engine, plan)
    for _ in range(int(rng.integers(1, 7))):
        if rng.random() < 2 / 3:
            engine.step()
        else:
            occupied = [s for s, r in enumerate(engine.slot_req)
                        if r is not None]
            if occupied:
                engine.preempt_slot(occupied[rng.integers(len(occupied))])
        _conserved(engine, plan)
    assert engine.run(max_ticks=600) == 0
    _conserved(engine, plan)
    for r in reqs:
        assert r.state in TERMINAL_STATES, (r.uid, r.state)
        assert r.done == (r.state == DONE)
        assert r.done_tick is not None and r.done_time is not None
    rs = engine.resilience_stats()
    assert rs["quarantined"] == rs["retried"] + sum(
        1 for r in reqs if r.state == FAILED)
    plan.release_held()
    _conserved(engine, plan)
    engine.tree.clear()
    engine.pool.check(Counter())
    assert engine.pool.free_pages == engine.pool.num_pages


# --- run loop, arrivals, tracer (tests/test_serve_engine.py:347-450) --------


def test_bursty_arrivals_outputs_schedule_independent(mp):
    model, params = mp
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=3, record_traffic=False, device="cpu")
    kw = dict(seed=3, vocab=512, arrival_rate=0.3, burst_amp=0.8,
              burst_period=24.0, prompt_bounds=(2, 9), new_bounds=(1, 7))
    out_bursty = run_arrivals(eng, poisson_requests(9, **kw))
    assert len(out_bursty) == 9
    eng.reset()
    assert out_bursty == run_staggered(eng, [poisson_requests(9, **kw)])


def test_pressure_burst_sheds_and_times_out():
    """``chip_smoke.py``'s pressure run at reduced size: 24 arrivals at 2 a
    tick on 8 slots (K=8) with a queue cap of 8 and deadlines 14 ticks
    past arrival.  The schedule has no eos, so it holds at any width: 7
    DONE, 8 SHED, and 9 TIMED_OUT, 4 of them in the queue."""
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=512, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    eng = Engine(model, params, slots=8, max_len=512, ticks_per_sync=8,
                 record_traffic=False, device="cpu",
                 shed_policy=ShedPolicy(max_queue_depth=8))
    reqs = poisson_requests(24, seed=0, vocab=cfg.vocab_size,
                            arrival_rate=2.0, burst_amp=0.5,
                            burst_period=64, prompt_bounds=(16, 300),
                            new_bounds=(16, 64), deadline_ticks=14)
    run_arrivals(eng, reqs)
    assert Counter(r.state for r in reqs) == {DONE: 7, TIMED_OUT: 9,
                                              SHED: 8}
    queued = [r for r in reqs if r.state == TIMED_OUT and not r.output]
    assert len(queued) == 4
    assert all("expired in queue" in r.reason for r in queued)
    assert all("mid-decode" in r.reason for r in reqs
               if r.state == TIMED_OUT and r.output)
    assert all("queue depth" in r.reason for r in reqs if r.state == SHED)
    rs = eng.resilience_stats()
    assert (rs["shed"], rs["timed_out"], rs["quarantined"]) == (8, 9, 0)


def test_run_budget_is_k_granular_and_reports_unfinished(mp):
    model, params = mp
    eng = Engine(model, params, slots=2, max_len=MAX_LEN, ticks_per_sync=4,
                 record_traffic=False, device="cpu")
    for uid in range(3):
        eng.submit(Request(uid=uid, prompt=[2 + uid, 3], max_new_tokens=20))
    left = eng.run(max_ticks=6)      # one K=4 window fits, a second doesn't
    assert eng.ticks == 4
    assert left == 3                 # 2 mid-decode in slots + 1 queued
    assert eng.run() == 0
    assert all(r is None for r in eng.slot_req)


def test_run_arrivals_strict_raises_on_budget_exhaustion(mp):
    model, params = mp
    eng = Engine(model, params, slots=1, max_len=MAX_LEN, ticks_per_sync=2,
                 record_traffic=False, device="cpu")
    kw = dict(seed=0, vocab=512, arrival_rate=2.0, prompt_bounds=(2, 4),
              new_bounds=(6, 10))
    with pytest.raises(RuntimeError, match="did not finish"):
        run_arrivals(eng, poisson_requests(4, **kw), max_ticks=4)
    eng.reset()
    partial = run_arrivals(eng, poisson_requests(4, **kw), max_ticks=4,
                           strict=False)
    assert len(partial) < 4


def test_engine_latency_stamps_and_tracer(mp):
    model, params = mp
    tracer = Tracer(name="test")
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, record_traffic=False, tracer=tracer,
                 device="cpu")
    reqs = poisson_requests(6, seed=4, vocab=512, arrival_rate=0.5,
                            prompt_bounds=(2, 8), new_bounds=(2, 6))
    run_arrivals(eng, reqs)
    for r in reqs:
        assert r.done and r.submit_time is not None
        assert r.admit_time is not None and r.done_time is not None
        assert r.submit_tick <= r.admit_tick == r.first_token_tick
        assert r.submit_time <= r.admit_time <= r.done_time
    s = latency_summary(reqs)
    assert s["completed"] == s["n"] == 6
    for domain, key in (("wall", "e2e_s"), ("ticks", "e2e")):
        assert {"p50", "p95", "p99"} <= set(s[domain][key])
    trace = tracer.to_chrome_trace()
    validate_chrome_trace(trace)
    cats = {e.get("cat") for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"prefill", "decode", "host"} <= cats


def test_submit_never_raises_marks_failed_and_keeps_serving(mp):
    model, params = mp
    eng = Engine(model, params, slots=1, max_len=8, ticks_per_sync=1,
                 record_traffic=False, device="cpu")
    bad = [Request(uid=0, prompt=[], max_new_tokens=1),
           Request(uid=1, prompt=list(range(9)), max_new_tokens=1),
           Request(uid=2, prompt=[1], max_new_tokens=0)]
    for b in bad:
        assert eng.submit(b) is False
    assert [b.state for b in bad] == [FAILED] * 3
    assert len(eng._queue) == 0
    good = Request(uid=3, prompt=[1, 2, 3], max_new_tokens=3)
    assert eng.submit(good) is True
    assert eng.run() == 0 and good.state == DONE
    assert eng.resilience_stats()["failed"] == 3


def test_charge_prefill_ticks_rewards_prefix_sharing(mp, ref):
    """With prefill charged to the tick clock, the paged engine's mean TTFT
    on a shared-prefix workload beats the dense engine's, and outputs stay
    the reference's (tests/test_paged_cache.py)."""
    model, params = mp
    reqs = shared_prefix_requests(9, seed=6, vocab=512, num_templates=2,
                                  template_len=26, suffix_lens=(2, 6),
                                  max_new=(3, 8))
    want = {r.uid: _alone(ref, r.prompt, r.max_new_tokens) for r in reqs}
    plain = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                   ticks_per_sync=2, record_traffic=False, device="cpu")
    rp0 = copy.deepcopy(reqs)
    run_staggered(plain, staggered_groups(rp0, SLOTS))
    dense = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                   ticks_per_sync=2, record_traffic=False,
                   charge_prefill_ticks=True, device="cpu")
    rd = copy.deepcopy(reqs)
    assert run_staggered(dense, staggered_groups(rd, SLOTS)) == want
    paged = PagedEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                        page_size=8, ticks_per_sync=2, record_traffic=False,
                        charge_prefill_ticks=True, device="cpu")
    rp = copy.deepcopy(reqs)
    assert run_staggered(paged, staggered_groups(rp, SLOTS)) == want
    ttft = {k: latency_summary(v)["ticks"]["ttft"]["mean"]
            for k, v in (("plain", rp0), ("dense", rd), ("paged", rp))}
    assert ttft["paged"] < ttft["dense"] and ttft["plain"] < ttft["dense"]
    assert dense.ticks > plain.ticks


# --- the same FaultPlan through the JAX engines and the port's --------------


def _ns(pkg, model, params):
    """The engine factory and names of one package."""
    if pkg == "jax":
        kw = dict(record_traffic=False, attn_impl="xla")
        m = jserve
    else:
        kw = dict(record_traffic=False, device="cpu")
        m = tserve
    return types.SimpleNamespace(
        m=m, engine=lambda cls, **k: getattr(m, cls)(
            model, params, **dict(kw, **k)))


def _outcome(reqs, eng, plan):
    out = {"reqs": [(r.uid, r.state, r.reason, list(r.output), r.done_tick,
                     r.admit_tick, r.first_token_tick, r.submit_tick,
                     r.retries, r.preemptions, r.defers) for r in reqs],
           "rstats": eng.resilience_stats(), "ticks": eng.ticks,
           "injected": dict(plan.injected) if plan else None,
           "log": list(plan.log) if plan else None}
    if hasattr(eng, "paged_stats"):
        out["paged"] = eng.paged_stats()
    return out


def _scenario_dense(ns):
    """Staggered mixed requests on Engine with a NaN row, a corrupt KV row
    and a launch stall; one request's deadline cuts it mid-decode."""
    m = ns.m
    plan = m.FaultPlan([m.Fault("nan_logits", at=1),
                        m.Fault("kv_corrupt", at=3),
                        m.Fault("window_stall", at=2)], seed=5)
    eng = ns.engine("Engine", slots=SLOTS, max_len=MAX_LEN,
                    ticks_per_sync=2, fault_plan=plan,
                    watchdog=m.WindowWatchdog(backoff_s=0.0),
                    shed_policy=m.ShedPolicy(max_retries=2))
    reqs = m.mixed_requests(7, seed=5, vocab=512, prompt_lens=(2, 9),
                            max_new=(4, 10))
    reqs[3].deadline = 6.0
    for group in m.staggered_groups(reqs, 3):
        for r in group:
            eng.submit(r)
        eng.step()
    assert eng.run() == 0
    return reqs, eng, plan


def _scenario_arrivals(ns):
    """Poisson arrivals with deadlines and a queue cap, a NaN row that
    fails twice, a stall that degrades the gate."""
    m = ns.m
    plan = m.FaultPlan([m.Fault("nan_logits", at=2, count=3, slot=1),
                        m.Fault("window_stall", at=0, count=3)], seed=1)
    eng = ns.engine("Engine", slots=SLOTS, max_len=MAX_LEN,
                    ticks_per_sync=2, fault_plan=plan,
                    watchdog=m.WindowWatchdog(backoff_s=0.0),
                    shed_policy=m.ShedPolicy(max_queue_depth=3,
                                             max_retries=1))
    reqs = m.poisson_requests(12, seed=2, vocab=512, arrival_rate=0.8,
                              burst_amp=0.5, burst_period=16.0,
                              prompt_bounds=(2, 10), new_bounds=(2, 9),
                              deadline_ticks=24)
    m.run_arrivals(eng, reqs)
    return reqs, eng, plan


def _scenario_paged(ns):
    """Shared-prefix requests on a tight pool: a steal of the free pages, a
    copy storm, a corrupt (tree-shared) first page, a preemption, and a
    deferral cap."""
    m = ns.m
    plan = m.FaultPlan([m.Fault("pool_exhaust", at=1, pages=6, hold=2),
                        m.Fault("cow_storm", at=2, pages=3),
                        m.Fault("kv_corrupt", at=3)], seed=7)
    eng = ns.engine("PagedEngine", slots=SLOTS, max_len=MAX_LEN,
                    page_size=8, num_pages=2 * (MAX_LEN // 8) + 2,
                    ticks_per_sync=2, fault_plan=plan,
                    watchdog=m.WindowWatchdog(backoff_s=0.0),
                    shed_policy=m.ShedPolicy(max_defers=6))
    reqs = m.shared_prefix_requests(8, seed=5, vocab=512, num_templates=2,
                                    template_len=26, suffix_lens=(2, 6),
                                    max_new=(2, 8))
    for r in reqs:
        eng.submit(r)
    eng.step()
    eng.step()
    busy = [s for s, r in enumerate(eng.slot_req) if r is not None]
    eng.preempt_slot(busy[0])
    assert eng.run() == 0
    plan.release_held()
    return reqs, eng, plan


def _scenario_unchecked(ns):
    """The health check off: a NaN row and a corrupt KV row decode on (no
    quarantine), in both packages alike."""
    m = ns.m
    plan = m.FaultPlan([m.Fault("nan_logits", at=1),
                        m.Fault("kv_corrupt", at=2)], seed=4)
    eng = ns.engine("Engine", slots=SLOTS, max_len=MAX_LEN,
                    ticks_per_sync=2, fault_plan=plan, health_check=False,
                    watchdog=m.WindowWatchdog(backoff_s=0.0))
    reqs = m.mixed_requests(6, seed=8, vocab=512, prompt_lens=(2, 9),
                            max_new=(4, 10))
    m.run_staggered(eng, m.staggered_groups(reqs, SLOTS))
    return reqs, eng, plan


@pytest.mark.parametrize("scenario", [_scenario_dense, _scenario_arrivals,
                                      _scenario_paged, _scenario_unchecked],
                         ids=["dense", "arrivals", "paged", "unchecked"])
def test_fault_plan_outcomes_match_jax(both, scenario):
    jmodel, jparams, model, params = both
    jreqs, jeng, jplan = scenario(_ns("jax", jmodel, jparams))
    treqs, teng, tplan = scenario(_ns("torch", model, params))
    want = _outcome(jreqs, jeng, jplan)
    got = _outcome(treqs, teng, tplan)
    assert got == want
    states = {r[1] for r in got["reqs"]}
    assert states <= TERMINAL_STATES and DONE in states
    assert sum(got["injected"].values()) > 0
    rs = got["rstats"]
    assert rs["quarantined"] == rs["retried"] + sum(
        1 for r in treqs if r.state == FAILED and r.retries)
    if "paged" in got:
        teng.pool.check(teng.tree.held_refs())
    if not teng.health_check:
        # nothing quarantined, yet the poisoned rows emitted other tokens
        # than a run without the plan
        assert rs["quarantined"] == 0 and states == {DONE}
        teng.reset()
        teng.fault_plan = None
        clean = tserve.mixed_requests(6, seed=8, vocab=512,
                                      prompt_lens=(2, 9), max_new=(4, 10))
        tserve.run_staggered(teng, tserve.staggered_groups(clean, SLOTS))
        assert [r.output for r in treqs] != [r.output for r in clean]


def test_fault_plan_outcomes_match_jax_guarded_family():
    """A guarded family (reduced mamba2): kv_corrupt poisons the slot's
    whole recurrent row; quarantine resets it, and the retry ends as the
    JAX engine's does, token for token."""
    jmodel, jparams, model, params = _convert("mamba2-1.3b", 32)
    res = []
    for pkg, mdl, prm in (("jax", jmodel, jparams),
                          ("torch", model, params)):
        ns = _ns(pkg, mdl, prm)
        m = ns.m
        plan = m.FaultPlan([m.Fault("kv_corrupt", at=1),
                            m.Fault("nan_logits", at=2)], seed=3)
        eng = ns.engine("Engine", slots=SLOTS, max_len=32, ticks_per_sync=2,
                        fault_plan=plan,
                        watchdog=m.WindowWatchdog(backoff_s=0.0))
        reqs = m.mixed_requests(5, seed=9, vocab=512, prompt_lens=(2, 7),
                                max_new=(3, 8))
        m.run_staggered(eng, m.staggered_groups(reqs, SLOTS))
        res.append(_outcome(reqs, eng, plan))
    assert res[1] == res[0]
    assert res[1]["rstats"]["quarantined"] >= 2
    assert all(r[1] == DONE for r in res[1]["reqs"])
