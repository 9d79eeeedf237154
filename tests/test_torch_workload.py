"""The port's traffic generator (``repro_torch.serve.workload``) against the
JAX package's, on the CPU.

The model-free cases of ``tests/test_traffic_gen.py`` (Poisson arrival
statistics, burst modulation, lognormal length bounds, seeded
reproducibility, input validation) run on the port; the generators are
numpy-seeded, so ``poisson_arrivals``, ``lognormal_lengths`` and
``poisson_requests`` must equal JAX's bit for bit.  Then the same
``poisson_requests`` through ``run_arrivals`` on the JAX ``Engine`` (xla
path) and the port's: equal outputs, states and tick stamps.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import (Engine, EngineReference,  # noqa: E402
                               ShedPolicy, lognormal_lengths,
                               poisson_arrivals, poisson_requests,
                               run_arrivals)

MAX_LEN = 48
SLOTS = 3


def test_arrivals_sorted_strictly_increasing():
    t = poisson_arrivals(500, rate=0.5, rng=np.random.default_rng(0))
    assert len(t) == 500
    assert np.all(t > 0) and np.all(np.diff(t) > 0)


def test_homogeneous_poisson_mean_within_tolerance():
    rng = np.random.default_rng(1)
    for rate in (0.25, 2.0):
        t = poisson_arrivals(4000, rate=rate, rng=rng)
        assert float(np.mean(np.diff(t))) == pytest.approx(1.0 / rate,
                                                          rel=0.1)


def test_burst_modulation_shifts_mass_into_the_peak():
    period = 40.0
    t = poisson_arrivals(6000, rate=1.0, rng=np.random.default_rng(2),
                         burst_amp=0.9, burst_period=period)
    assert np.all(np.diff(t) > 0)
    peak = int(np.sum(np.mod(t, period) < period / 2))
    assert peak > 1.5 * (len(t) - peak)


def test_burst_zero_matches_homogeneous_stream():
    t = poisson_arrivals(3000, rate=0.5, rng=np.random.default_rng(3),
                         burst_amp=0.0)
    assert float(np.mean(np.diff(t))) == pytest.approx(2.0, rel=0.1)


def test_lognormal_lengths_honor_bounds():
    ls = lognormal_lengths(2000, rng=np.random.default_rng(4), log_mean=2.0,
                           sigma=1.0, bounds=(3, 17))
    assert ls.min() >= 3 and ls.max() <= 17 and ls.dtype == np.int64
    assert (ls == 3).any() and (ls == 17).any()


def test_mean_rate_against_integrated_intensity():
    n, rate = 5000, 1.0
    t = poisson_arrivals(n, rate=rate, rng=np.random.default_rng(5),
                         burst_amp=0.8, burst_period=16.0)
    assert math.isclose(t[-1], n / rate, rel_tol=0.1)


@pytest.mark.parametrize("kw", [
    dict(rate=0.5), dict(rate=2.0, burst_amp=0.9, burst_period=40.0),
    dict(rate=0.25, burst_amp=1.0, burst_period=7.0)])
def test_arrivals_and_lengths_equal_jax_bitwise(kw):
    got = poisson_arrivals(700, rng=np.random.default_rng(11), **kw)
    want = jserve.poisson_arrivals(700, rng=np.random.default_rng(11), **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    lk = dict(log_mean=2.0, sigma=1.0, bounds=(3, 17))
    assert np.array_equal(
        lognormal_lengths(900, rng=np.random.default_rng(12), **lk),
        jserve.lognormal_lengths(900, rng=np.random.default_rng(12), **lk))


def _fields(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("kw", [
    dict(seed=7, vocab=256, arrival_rate=0.5, burst_amp=0.5,
         prompt_bounds=(2, 11), new_bounds=(1, 9)),
    dict(seed=0, temperature=0.7, temperature_every=2),
    dict(seed=3, vocab=128256, arrival_rate=0.5, burst_amp=0.5,
         burst_period=64, prompt_bounds=(16, 300), new_bounds=(16, 64),
         deadline_ticks=256),
])
def test_poisson_requests_equal_jax(kw):
    """Every field of every request (prompt, budgets, arrival, deadline,
    temperature) equals the JAX generator's, bit for bit."""
    got = [_fields(r) for r in poisson_requests(40, **kw)]
    assert got == [_fields(r) for r in jserve.poisson_requests(40, **kw)]


def test_poisson_requests_bounds_and_reproducibility():
    kw = dict(seed=7, vocab=256, arrival_rate=0.5, burst_amp=0.5,
              prompt_bounds=(2, 11), new_bounds=(1, 9))
    a = poisson_requests(50, **kw)
    assert [_fields(r) for r in a] == [_fields(r)
                                       for r in poisson_requests(50, **kw)]
    assert [r.prompt for r in a] != [r.prompt for r in poisson_requests(
        50, **dict(kw, seed=8))]
    assert [r.arrival for r in a] == sorted(r.arrival for r in a)
    assert [r.uid for r in a] == list(range(50))
    for r in a:
        assert 2 <= len(r.prompt) <= 11 and 1 <= r.max_new_tokens <= 9
        assert all(1 <= t < 256 for t in r.prompt) and r.arrival > 0
    d = poisson_requests(5, seed=1, deadline_ticks=10)
    assert all(r.deadline == r.arrival + 10 for r in d)


def test_poisson_requests_temperature_every():
    reqs = poisson_requests(6, seed=0, temperature=0.7, temperature_every=2)
    assert [r.temperature for r in reqs] == [0.0, 0.7] * 3


def test_generator_validation():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(5, rate=0.0, rng=rng)
    with pytest.raises(ValueError, match="burst_amp"):
        poisson_arrivals(5, rate=1.0, rng=rng, burst_amp=1.5)
    with pytest.raises(ValueError, match="burst_period"):
        poisson_arrivals(5, rate=1.0, rng=rng, burst_amp=0.5,
                         burst_period=0.0)
    with pytest.raises(ValueError, match="bounds"):
        lognormal_lengths(5, rng=rng, log_mean=1.0, sigma=0.5,
                          bounds=(9, 3))


# --- run_arrivals against the JAX engine ------------------------------------


@pytest.fixture(scope="module")
def both():
    jcfg = jreduced(jget_config("llama3-8b"), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


def _stamps(reqs):
    return [(r.uid, r.state, r.reason, list(r.output), r.submit_tick,
             r.admit_tick, r.done_tick) for r in reqs]


@pytest.mark.parametrize("K,policy", [
    (2, {}), (3, dict(max_queue_depth=2)),
], ids=["K2", "K3_queue_cap"])
def test_run_arrivals_matches_jax(both, K, policy):
    """Bursty arrivals with deadlines through both packages' Engine: the
    same outputs, terminal states (queue-cap sheds and deadline time-outs
    included), reasons and tick stamps; the tick clock ends where JAX's
    does (idle fast-forwards and stall advances alike)."""
    jmodel, jparams, model, params = both
    kw = dict(seed=5, vocab=512, arrival_rate=1.5, burst_amp=0.8,
              burst_period=24.0, prompt_bounds=(2, 12), new_bounds=(2, 10),
              deadline_ticks=16)
    jeng = jserve.Engine(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                         ticks_per_sync=K, record_traffic=False,
                         shed_policy=jserve.ShedPolicy(**policy))
    jreqs = jserve.poisson_requests(14, **kw)
    jout = jserve.run_arrivals(jeng, jreqs)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=K, shed_policy=ShedPolicy(**policy),
                 device="cpu")
    reqs = poisson_requests(14, **kw)
    assert run_arrivals(eng, reqs) == jout
    assert _stamps(reqs) == _stamps(jreqs)
    assert eng.ticks == jeng.ticks
    assert eng.resilience_stats() == jeng.resilience_stats()
    assert len({r.state for r in reqs}) > 1       # not all DONE


def test_reference_run_arrivals_matches_jax(both):
    jmodel, jparams, model, params = both
    kw = dict(seed=6, vocab=512, arrival_rate=0.4, prompt_bounds=(2, 9),
              new_bounds=(2, 7))
    jref = jserve.EngineReference(jmodel, jparams, slots=SLOTS,
                                  max_len=MAX_LEN)
    jreqs = jserve.poisson_requests(6, **kw)
    jout = jserve.run_arrivals(jref, jreqs)
    ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                          device="cpu")
    reqs = poisson_requests(6, **kw)
    assert run_arrivals(ref, reqs) == jout
    assert _stamps(reqs) == _stamps(jreqs)


# --- the launcher's arrival flags and the serving example -------------------


def test_launcher_serves_arrivals_with_admission_control(tmp_path, capsys):
    """``--arrival-rate`` with a deadline, a queue cap and a chrome trace:
    the run reports its terminal states and latency percentiles and writes
    a trace both packages' validators accept; ``--list-configs`` lists
    every config with the engines that serve it."""
    import json
    from repro.serve.telemetry import validate_chrome_trace as jvalidate
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import validate_chrome_trace
    trace = tmp_path / "serve.json"
    launch_serve.main(["--device", "cpu", "--arrival-rate", "0.5",
                       "--deadline-ticks", "64", "--max-queue-depth", "4",
                       "--trace-out", str(trace), "--no-verdicts"])
    text = capsys.readouterr().out
    assert "terminal states: " in text and "ticks ttft" in text
    assert "chrome trace (" in text
    obj = json.loads(trace.read_text())
    validate_chrome_trace(obj)
    jvalidate(obj)
    launch_serve.main(["--list-configs"])
    listing = capsys.readouterr().out
    assert "llama3-8b" in listing and "PagedEngine" in listing
    assert "mamba2-1.3b            ssm      Engine, EngineReference" \
        in listing


def test_serve_demo_schedule_matches_the_jax_example(monkeypatch, capsys):
    """The port's serve demo runs the JAX example's schedule: the same
    windows, active counts, done ticks and host syncs (the tokens differ:
    each package draws its own weights)."""
    import runpy
    import sys
    from pathlib import Path
    from repro_torch.examples import serve_demo

    def schedule(text):
        return [line.split(" -> output=")[0] + " "
                + line.rsplit("(", 1)[-1]
                if line.startswith("req ") else line
                for line in text.splitlines()
                if line.startswith(("window", "req", "served"))]

    serve_demo.main(["--device", "cpu"])
    got = schedule(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve_demo.py"])
    runpy.run_path(str(Path(__file__).resolve().parents[1] / "examples"
                       / "serve_demo.py"), run_name="__main__")
    want = schedule(capsys.readouterr().out)
    assert got == want and got[-1].startswith("served 6 requests")
