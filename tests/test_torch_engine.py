"""The port's serve engines (``repro_torch.serve``) against the JAX
package's, on the CPU, with the same weights and the same requests.

Greedy outputs depend only on each request's prompt (slot isolation), so
the port's ``Engine`` at any ``ticks_per_sync`` and its
``EngineReference`` must emit, token for token, what the JAX package's
``EngineReference`` and ``Engine`` emit on the mixed workload of
``tests/test_serve_engine.py``.
"""
import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.serve import Engine as JEngine
from repro.serve import EngineReference as JEngineReference
from repro.serve import mixed_requests as jmixed_requests
from repro.serve import run_staggered as jrun_staggered
from repro.serve import staggered_groups as jstaggered_groups
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (DONE, FAILED, Engine, EngineReference,
                               Request, latency_summary, mixed_requests,
                               percentile, run_staggered, staggered_groups)

MAX_LEN = 48
SLOTS = 3


def _workload(n=7, seed=0, **kw):
    kw.setdefault("prompt_lens", (2, 9))
    kw.setdefault("max_new", (2, 8))
    return mixed_requests(n, seed=seed, vocab=512, **kw)


def _jworkload(n=7, seed=0, **kw):
    kw.setdefault("prompt_lens", (2, 9))
    kw.setdefault("max_new", (2, 8))
    return jmixed_requests(n, seed=seed, vocab=512, **kw)


def _eos_exiting_early(outputs):
    """A token that ends some request early: it occurs at index >= 1 of an
    output and is no output's first token, so the eos run exits that
    request at length > 1 (the JAX suite's probe takes the first token at
    index >= 1 and can pick a token that ends another request at
    length 1)."""
    firsts = {o[0] for o in outputs.values()}
    for o in outputs.values():
        for t in o[1:]:
            if t not in firsts:
                return t
    raise AssertionError("no early-exit eos token in this workload")


@pytest.fixture(scope="module")
def mp():
    jcfg = jreduced(jget_config("llama3-8b"), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def jax_reference(mp):
    """JAX EngineReference outputs on the mixed workload, eos-free and with
    an eos that exits a request early."""
    jmodel, jparams, _, _ = mp
    ref = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN)
    free = jrun_staggered(ref, jstaggered_groups(_jworkload(seed=5), 2))
    eos = _eos_exiting_early(free)
    ref = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                           eos_id=eos)
    with_eos = jrun_staggered(ref, jstaggered_groups(_jworkload(seed=5), 2))
    return free, eos, with_eos


def test_eos_workload_exercises_an_early_exit(jax_reference):
    free, eos, with_eos = jax_reference
    assert any(o[-1] == eos and len(o) > 1 for o in with_eos.values())
    assert with_eos != free


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_engine_greedy_parity_vs_jax(mp, jax_reference, K, impl):
    """Staggered arrivals, uneven lengths, eos exits: the port's Engine
    emits the JAX reference's tokens, token for token."""
    _, _, model, params = mp
    free, eos, with_eos = jax_reference
    for eos_id, want in ((None, free), (eos, with_eos)):
        eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                     eos_id=eos_id, ticks_per_sync=K, attn_impl=impl,
                     sample_impl=impl, device="cpu")
        out = run_staggered(eng, staggered_groups(_workload(seed=5), 2))
        assert out == want, f"K={K} impl={impl} eos={eos_id}"


def test_engine_reference_parity_vs_jax(mp, jax_reference):
    _, _, model, params = mp
    free, eos, with_eos = jax_reference
    for eos_id, want in ((None, free), (eos, with_eos)):
        ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                              eos_id=eos_id, device="cpu")
        assert run_staggered(ref, staggered_groups(_workload(seed=5),
                                                   2)) == want


def test_engine_parity_vs_jax_engine(mp):
    """The JAX fused Engine at K=4 on another workload, against the port's
    Engine at K=4 and the port's EngineReference."""
    jmodel, jparams, model, params = mp
    jeng = JEngine(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                   ticks_per_sync=4, record_traffic=False)
    want = jrun_staggered(jeng, jstaggered_groups(_jworkload(seed=6), 3))
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=4, device="cpu")
    ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                          device="cpu")
    assert run_staggered(eng, staggered_groups(_workload(seed=6), 3)) == want
    assert run_staggered(ref, staggered_groups(_workload(seed=6), 3)) == want


def test_tick_stamps_match_the_reference(mp):
    """Admission, first-token and done ticks agree between Engine at K=1
    and EngineReference (the tick-domain semantics of Request)."""
    _, _, model, params = mp
    stamps = []
    for make in (lambda: Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                                ticks_per_sync=1, device="cpu"),
                 lambda: EngineReference(model, params, slots=SLOTS,
                                         max_len=MAX_LEN, device="cpu")):
        reqs = _workload(seed=5)
        run_staggered(make(), staggered_groups(reqs, 2))
        stamps.append([(r.admit_tick, r.first_token_tick, r.done_tick)
                       for r in reqs])
    assert stamps[0] == stamps[1]


def test_prefill_leaves_other_slots_bitwise(mp):
    """Admission scatters the prompt KV into the admitted slot only; rows
    of a slot mid-decode and of free slots keep their bits, and the
    mid-decode request ends as it would alone."""
    _, _, model, params = mp
    alone = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                   ticks_per_sync=2, device="cpu")
    ra = Request(uid=0, prompt=[5, 7, 11, 13], max_new_tokens=10)
    alone.submit(ra)
    alone.run()

    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for c in eng.cache.values():
        c.copy_(torch.randn(c.shape, generator=gen))
    a = Request(uid=0, prompt=list(ra.prompt), max_new_tokens=10)
    eng.submit(a)
    eng.step()
    before = {n: c.clone() for n, c in eng.cache.items()}
    eng.submit(Request(uid=1, prompt=[101, 102, 103], max_new_tokens=4))
    eng._admit()                                  # lands in slot 1
    for n, c in eng.cache.items():
        assert torch.equal(c[:, [0, 2]], before[n][:, [0, 2]])
        assert not torch.equal(c[:, 1, :3], before[n][:, 1, :3])
        assert torch.equal(c[:, 1, 3:], before[n][:, 1, 3:])
    eng.run()
    assert a.output == ra.output


def test_temperature_sampling_seeded_and_impl_independent(mp):
    """Temperature rows: same seed, same tokens; another seed, other
    tokens; the kernel wrapper and the plain sampler draw alike."""
    _, _, model, params = mp

    def go(seed, impl):
        eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN, seed=seed,
                     ticks_per_sync=2, sample_impl=impl, device="cpu")
        reqs = _workload(5, seed=7, temperature=0.9, temperature_every=1)
        return run_staggered(eng, staggered_groups(reqs, 2))

    a = go(0, "kernel")
    assert a == go(0, "kernel") == go(0, "plain")
    assert a != go(1, "kernel")
    assert all(0 <= t < 512 for o in a.values() for t in o)


def test_malformed_requests_fail_and_serving_goes_on(mp):
    _, _, model, params = mp
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    bad = [Request(uid=0, prompt=[], max_new_tokens=3),
           Request(uid=1, prompt=[1] * (MAX_LEN + 1), max_new_tokens=3),
           Request(uid=2, prompt=[1, 2], max_new_tokens=0)]
    good = Request(uid=3, prompt=[1, 2, 3], max_new_tokens=3)
    assert [eng.submit(r) for r in bad + [good]] == [False] * 3 + [True]
    assert eng.run() == 0
    assert [r.state for r in bad] == [FAILED] * 3
    assert all(r.reason for r in bad) and good.state == DONE
    assert len(good.output) == 3


def test_engine_checks_impls_and_device(mp, monkeypatch):
    _, _, model, params = mp
    with pytest.raises(ValueError, match="attn_impl"):
        Engine(model, params, slots=1, max_len=8, attn_impl="xla",
               device="cpu")
    with pytest.raises(ValueError, match="sample_impl"):
        Engine(model, params, slots=1, max_len=8, sample_impl="pallas",
               device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (Engine, EngineReference):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(model, params, slots=1, max_len=8)


def test_counts_and_no_launches_on_cpu(mp):
    """The engine's tick and prefill counters (which the on-card smoke
    holds the kernel launch counts to) and no kernel launch on CPU
    tensors."""
    _, _, model, params = mp
    ops.reset_launches()
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    run_staggered(eng, staggered_groups(_workload(seed=2), 3))
    assert eng.counts["decode_ticks"] == eng.ticks > 0
    assert eng.counts["prefill_calls"] >= 3
    assert eng.counts["nonfinite_rows"] == 0
    assert ops.launches == {"decode_attention": 0,
                            "paged_decode_attention": 0, "fused_sample": 0,
                            "cache_sim": 0, "cache_sim_ladder": 0,
                            "ssd_scan": 0, "rglru_scan": 0,
                            "flash_attention": 0}


def test_latency_summary_over_served_requests(mp):
    _, _, model, params = mp
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    reqs = _workload(seed=3)
    run_staggered(eng, staggered_groups(reqs, 2))
    s = latency_summary(reqs)
    assert s["n"] == s["completed"] == 7 and s["states"] == {DONE: 7}
    assert s["tokens"] == sum(len(r.output) for r in reqs)
    ttft = [r.first_token_time - r.submit_time for r in reqs]
    assert s["wall"]["ttft_s"]["p50"] == pytest.approx(
        float(np.percentile(ttft, 50)))
    assert set(s["ticks"]) == {"e2e", "tpot", "ttft"}
    assert percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.5


def test_launcher_serves_on_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--requests", "4",
                           "--slots", "2", "--max-len", "32",
                           "--temperature", "0.7"])
    text = buf.getvalue()
    assert "served 4 requests" in text and "DONE=4" in text
