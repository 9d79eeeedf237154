"""The port's ``Engine`` with its admission prefill through the flash route
(``prefill_attn_impl="kernel"``) against the JAX ``Engine`` with
``prefill_attn_impl="chunked"``, on the CPU, with the same weights (the
JAX package's ``model.init`` through ``params_from_numpy``) and the same
requests: greedy tokens equal, token for token, at f32 (the engine pads
prompts to a power of two, so both routes see the padded keys and only
the last prompt position's logits are read).
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import mixed_requests as jmixed_requests  # noqa: E402
from repro.serve import run_staggered as jrun_staggered  # noqa: E402
from repro.serve import staggered_groups as jstaggered_groups  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import (Engine, EngineReference,  # noqa: E402
                               PagedEngine, mixed_requests, run_staggered,
                               staggered_groups)

MAX_LEN = 64
SLOTS = 3


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


def _spy(monkeypatch):
    """Count ``chunked_attention`` calls (the flash route of a prefill)."""
    calls = []
    real = attention.chunked_attention
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(
                            *a, **k))
    return calls


@pytest.mark.parametrize("K", [1, 4])
def test_kernel_prefill_engine_matches_jax_chunked_engine(mp, K,
                                                          monkeypatch):
    jmodel, jparams, model, params = mp
    kw = dict(prompt_lens=(3, 30), max_new=(2, 8))
    jeng = JEngine(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                   ticks_per_sync=K, record_traffic=False,
                   prefill_attn_impl="chunked")
    want = jrun_staggered(jeng, jstaggered_groups(
        jmixed_requests(8, seed=7, vocab=512, **kw), 3))
    calls = _spy(monkeypatch)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=K, prefill_attn_impl="kernel", device="cpu")
    got = run_staggered(eng, staggered_groups(
        mixed_requests(8, seed=7, vocab=512, **kw), 3))
    assert got == want
    layers = model.cfg.num_layers
    assert len(calls) == layers * eng.counts["prefill_calls"]
    # every call saw the padded prompt as its sequence
    assert {s[1] for s in calls} <= set(eng.counts["prefill_calls_by_len"])
    ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                          device="cpu")
    assert run_staggered(ref, staggered_groups(
        mixed_requests(8, seed=7, vocab=512, **kw), 3)) == want


def test_prefill_attn_impl_default_and_validation(mp, monkeypatch):
    """The default is the plain route (JAX's "naive"); an unknown route is
    refused; ``PagedEngine`` takes the argument through its keywords and
    its suffix prefill does not read it."""
    _, _, model, params = mp
    calls = _spy(monkeypatch)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN, device="cpu")
    assert eng.prefill_attn_impl == "plain"
    run_staggered(eng, staggered_groups(
        mixed_requests(3, seed=1, vocab=512, prompt_lens=(3, 9),
                       max_new=(2, 4)), 3))
    assert calls == []
    for bad in ("chunked", "naive", "kernel_bf16"):
        with pytest.raises(ValueError, match="prefill_attn_impl"):
            Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                   prefill_attn_impl=bad, device="cpu")
    peng = PagedEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                       prefill_attn_impl="kernel", device="cpu")
    assert peng.prefill_attn_impl == "kernel"
    want = run_staggered(eng, staggered_groups(
        mixed_requests(4, seed=2, vocab=512, prompt_lens=(3, 20),
                       max_new=(2, 6)), 2))
    assert run_staggered(peng, staggered_groups(
        mixed_requests(4, seed=2, vocab=512, prompt_lens=(3, 20),
                       max_new=(2, 6)), 2)) == want
    assert calls == []
