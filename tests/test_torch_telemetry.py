"""The port's serve telemetry (``repro_torch.serve.telemetry``) against the
JAX package's, on the CPU.

The model-free cases of ``tests/test_telemetry.py`` (hand-stamped requests,
percentile math, the chrome-trace exporter and its validator) run on the
port and, where a number comes out, against ``repro.serve.telemetry`` on
the same inputs.  Then the same requests through the JAX ``Engine`` /
``PagedEngine`` (xla path) and the port's, each with a ``Tracer``: the two
chrome traces hold equal multisets of ``(name, cat, ph)`` events, and the
tick-domain latency summaries are equal.
"""
import collections
import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

import repro.serve as jserve  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.serve import telemetry as jtelemetry  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import Request  # noqa: E402
from repro_torch.serve.telemetry import (Tracer, latency_summary,  # noqa
                                         percentile, request_latency,
                                         summarize, validate_chrome_trace)

MAX_LEN = 48
SLOTS = 3


# --- percentile math --------------------------------------------------------


def test_percentile_hand_computed():
    assert percentile([4, 1, 3, 2], 50) == 2.5
    assert percentile([4, 1, 3, 2], 0) == 1.0
    assert percentile([4, 1, 3, 2], 100) == 4.0
    assert percentile([10, 0], 25) == 2.5
    assert percentile(list(range(1, 101)), 99) == pytest.approx(99.01)
    assert percentile([7.0], 99) == 7.0


def test_percentile_and_summary_match_jax_and_numpy():
    rng = np.random.default_rng(0)
    xs = rng.lognormal(0.0, 1.0, size=137)
    for q in (0, 10, 50, 95, 99, 100):
        assert percentile(xs, q) == jtelemetry.percentile(xs, q)
        assert percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12)
    assert summarize(xs) == jtelemetry.summarize(xs)


def test_percentile_validation():
    with pytest.raises(ValueError, match="empty"):
        percentile([], 50)
    with pytest.raises(ValueError, match="outside"):
        percentile([1.0], 101)


def test_summarize_keys():
    s = summarize([1.0, 2.0, 3.0])
    assert set(s) == {"p50", "p95", "p99", "mean", "max"}
    assert s["p50"] == 2.0 and s["mean"] == 2.0 and s["max"] == 3.0
    assert summarize([]) == {}


# --- per-request latency ----------------------------------------------------


def _stamped(cls=Request, uid=0, *, arrival=None, submit_tick=0,
             submit_time=10.0, admit_tick=2, admit_time=10.5, done_tick=6,
             done_time=11.3, n_tokens=5):
    r = cls(uid=uid, prompt=[1, 2], max_new_tokens=n_tokens,
            output=list(range(n_tokens)), arrival=arrival)
    r.submit_tick, r.submit_time = submit_tick, submit_time
    r._mark_admitted(admit_tick, admit_time)
    r._mark_done(done_tick, done_time)
    return r


def test_request_latency_hand_computed():
    lat = request_latency(_stamped())
    assert lat["wall"]["ttft_s"] == pytest.approx(0.5)
    assert lat["wall"]["e2e_s"] == pytest.approx(1.3)
    assert lat["wall"]["tpot_s"] == pytest.approx(0.2)
    assert lat["ticks"] == {"ttft": 2, "e2e": 6, "tpot": 1.0}


@pytest.mark.parametrize("kw", [dict(), dict(arrival=1.5),
                                dict(n_tokens=1, done_tick=2,
                                     done_time=10.5)],
                         ids=["submit", "arrival", "one_token"])
def test_request_latency_matches_jax(kw):
    got = request_latency(_stamped(**kw))
    assert got == jtelemetry.request_latency(
        _stamped(jserve.Request, **kw))
    if "arrival" in kw:
        # tick-domain latencies charge the admission delay from arrival;
        # the wall clock still counts from the submit stamp
        assert got["ticks"]["ttft"] == pytest.approx(0.5)
        assert got["wall"]["ttft_s"] == pytest.approx(0.5)
    if kw.get("n_tokens") == 1:
        assert "tpot_s" not in got["wall"] and "tpot" not in got["ticks"]


def test_request_latency_none_for_unfinished_or_not_done():
    assert request_latency(Request(uid=0, prompt=[1],
                                   max_new_tokens=2)) is None
    r = _stamped()
    r.done = False                # e.g. a TIMED_OUT request
    assert request_latency(r) is None


def test_latency_summary_counts_and_percentiles():
    def reqs(cls):
        out = [_stamped(cls, uid=i, done_time=11.0 + i) for i in range(4)]
        out.append(cls(uid=9, prompt=[1], max_new_tokens=2))
        shed = cls(uid=10, prompt=[1], max_new_tokens=2)
        shed._finalize("SHED", 3, 12.0, reason="queue depth")
        shed.retries, shed.preemptions = 1, 2
        return out + [shed]

    s = latency_summary(reqs(Request))
    assert s == jtelemetry.latency_summary(reqs(jserve.Request))
    assert s["n"] == 6 and s["completed"] == 4 and s["tokens"] == 20
    assert s["shed"] == 1 and s["retries"] == 1 and s["preemptions"] == 2
    assert s["states"] == {"DONE": 4, "PENDING": 1, "SHED": 1}
    assert s["wall"]["e2e_s"]["p50"] == pytest.approx(2.5)
    assert s["ticks"]["ttft"]["p50"] == 2


def test_latency_summary_empty():
    s = latency_summary([])
    assert s["n"] == 0 and s["completed"] == 0
    assert s["wall"] == {} and s["ticks"] == {}


# --- chrome trace export ----------------------------------------------------


def _flat_trace(mod):
    tr = mod.Tracer(name="t")
    tr.span("prefill P=8", "prefill", 100.0, 100.5, args={"tick": 0})
    tr.span("decode_window", "decode", 100.5, 101.0, args={"K": 4})
    tr.counter("active_slots", {"active": 3}, 100.5)
    return tr


def test_tracer_exports_valid_chrome_trace(tmp_path):
    tr = _flat_trace(tserve)
    trace = tr.to_chrome_trace()
    validate_chrome_trace(trace)
    jtrace = _flat_trace(jserve).to_chrome_trace()
    assert trace["traceEvents"] == jtrace["traceEvents"]
    xs = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["prefill P=8", "decode_window"]
    assert xs[0]["ts"] == 0.0 and xs[0]["dur"] == pytest.approx(0.5e6)
    assert xs[1]["ts"] == pytest.approx(0.5e6)
    cs = [e for e in trace["traceEvents"] if e["ph"] == "C"]
    assert cs[0]["args"] == {"active": 3}
    path = tr.save(tmp_path / "trace.json")
    validate_chrome_trace(json.loads(path.read_text()))
    jtelemetry.validate_chrome_trace(json.loads(path.read_text()))


def test_tracer_rejects_negative_span():
    with pytest.raises(ValueError, match="end"):
        Tracer().span("x", "c", 2.0, 1.0)


def test_validate_chrome_trace_rejects_malformed():
    with pytest.raises(ValueError, match="traceEvents"):
        validate_chrome_trace({"events": []})
    with pytest.raises(ValueError, match="must be a list"):
        validate_chrome_trace({"traceEvents": {}})
    with pytest.raises(ValueError, match="phase"):
        validate_chrome_trace({"traceEvents": [{"ph": "Z"}]})
    with pytest.raises(ValueError, match="missing"):
        validate_chrome_trace({"traceEvents": [{"ph": "X", "name": "a"}]})
    with pytest.raises(ValueError, match="non-negative"):
        validate_chrome_trace({"traceEvents": [
            {"ph": "X", "name": "a", "ts": -1.0, "dur": 1.0,
             "pid": 0, "tid": 0}]})


def test_tracer_nested_spans_and_instants(tmp_path):
    def build(mod):
        tr = mod.Tracer(name="t")
        tr.begin("admit", "serve", 10.0, args={"n": 2})
        tr.begin("prefill_chunk S=8", "serve", 10.1)
        tr.instant("cow_copy", "serve", 10.15, args={"pairs": 1})
        tr.end(10.3)
        tr.instant("page_gather", "serve", 10.35, args={"upf": 0.5})
        tr.end(10.4, args={"pages_in_use": 7})
        return tr

    tr = build(tserve)
    trace = tr.to_chrome_trace()
    validate_chrome_trace(trace)
    assert trace["traceEvents"] == build(jserve).to_chrome_trace()[
        "traceEvents"]
    bs = [e for e in trace["traceEvents"] if e["ph"] == "B"]
    es = [e for e in trace["traceEvents"] if e["ph"] == "E"]
    ins = [e for e in trace["traceEvents"] if e["ph"] == "i"]
    assert [e["name"] for e in bs] == ["admit", "prefill_chunk S=8"]
    assert len(es) == 2 and es[0]["ts"] < es[1]["ts"]
    assert es[1]["args"] == {"pages_in_use": 7}
    assert [e["name"] for e in ins] == ["cow_copy", "page_gather"]
    assert all(e["s"] == "t" for e in ins)
    path = tr.save(tmp_path / "nested.json")
    validate_chrome_trace(json.loads(path.read_text()))


def test_tracer_begin_end_misuse_rejected():
    tr = Tracer()
    with pytest.raises(ValueError, match="without"):
        tr.end(1.0)
    tr.begin("a", "c", 2.0)
    with pytest.raises(ValueError, match="< begin"):
        tr.end(1.0)          # end earlier than its begin: span stays open
    with pytest.raises(ValueError, match="unclosed"):
        tr.to_chrome_trace()
    tr.end(3.0)
    validate_chrome_trace(tr.to_chrome_trace())


def test_validate_chrome_trace_rejects_unbalanced_spans():
    base = {"name": "a", "cat": "c", "ts": 0.0, "pid": 0, "tid": 0}
    with pytest.raises(ValueError, match="E"):
        validate_chrome_trace({"traceEvents": [{**base, "ph": "E"}]})
    with pytest.raises(ValueError, match="unbalanced|unclosed"):
        validate_chrome_trace({"traceEvents": [{**base, "ph": "B"}]})


# --- engine traces against the JAX engines' ---------------------------------


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


def _traced_run(mod, model, params, cls, **kw):
    tracer = mod.Tracer(name="serve")
    eng = getattr(mod, cls)(model, params, slots=SLOTS, max_len=MAX_LEN,
                            ticks_per_sync=2, record_traffic=False,
                            tracer=tracer, **kw)
    if cls == "PagedEngine":
        reqs = mod.shared_prefix_requests(
            8, seed=4, vocab=512, num_templates=2, template_len=26,
            suffix_lens=(2, 6), max_new=(2, 8))
    else:
        reqs = mod.poisson_requests(8, seed=4, vocab=512, arrival_rate=0.5,
                                    burst_amp=0.5, burst_period=16.0,
                                    prompt_bounds=(2, 12),
                                    new_bounds=(2, 8))
    mod.run_arrivals(eng, reqs)
    trace = tracer.to_chrome_trace()
    kinds = collections.Counter((e["name"], e.get("cat"), e["ph"])
                                for e in trace["traceEvents"])
    ticks = mod.latency_summary(reqs)["ticks"]
    return trace, kinds, ticks


@pytest.mark.parametrize("cls,extra", [
    ("Engine", {}),
    ("PagedEngine", {"page_size": 8, "num_pages": 2 * (MAX_LEN // 8) + 2}),
], ids=["dense", "paged"])
def test_engine_trace_events_match_jax(both, cls, extra):
    """The same requests through the JAX engine and the port's: equal
    multisets of (name, cat, ph), every span kind the engine records, and
    equal tick-domain latency summaries."""
    jmodel, jparams, model, params = both
    jtrace, jkinds, jticks = _traced_run(jserve, jmodel, jparams, cls,
                                         attn_impl="xla", **extra)
    trace, kinds, ticks = _traced_run(tserve, model, params, cls,
                                      device="cpu", **extra)
    validate_chrome_trace(trace)
    jtelemetry.validate_chrome_trace(trace)
    assert kinds == jkinds
    assert ticks == jticks
    names = {k[0].split(" ")[0] for k in kinds}
    want = {"decode_window", "host_drain", "active_slots",
            "process_name", "thread_name"}
    if cls == "PagedEngine":
        want |= {"admit", "prefill_chunk", "page_gather", "cow_copy"}
    else:
        want |= {"prefill"}
    assert want <= names
