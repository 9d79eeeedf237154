"""The port's encdec family (whisper-tiny) against the JAX package, on the
CPU: ``layer_norm`` and ``sinusoidal_positions``, the encoder, prefill
with ``frames`` and with ``enc_out``, vector- and scalar-position decode,
``encode_prompt``, the state banks, the serve engines token for token
against the JAX ``EngineReference`` on the cases of
``tests/test_serve_families.py``, the ``enc/out`` bank's rows, the
refusals, the shape cells and the launcher.

Weights: reduced whisper in f32, ``model.init(PRNGKey(0))`` through
``params_from_numpy``.  Tolerances: ``layer_norm`` 1e-6; the encoder,
prefill, decode and ``encode_prompt`` 1e-4 (``tests/test_torch_models.py``'s
bound: sums in another order than XLA's); decode against the full-sequence
forward 2e-3 (JAX's ``test_whisper_decode_matches_forward``); the
sinusoid table and the ``enc/out`` rows across the two port engines bit for
bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro.models.api import input_specs as jinput_specs
from repro.models.transformer import encoder_forward as jencoder_forward
from repro.serve import Engine as JEngine
from repro.serve import EngineReference as JEngineReference
from repro.serve import Request as JRequest
from repro.serve import mixed_requests as jmixed_requests
from repro.serve import run_staggered as jrun_staggered
from repro.serve import staggered_groups as jstaggered_groups
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import UnsupportedFamilyError, build_model
from repro_torch.models import api
from repro_torch.models.api import (WHISPER_DECODE_ENC_LEN, StateBank,
                                    input_specs, make_inputs)
from repro_torch.models.common import layer_norm, sinusoidal_positions
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.transformer import encoder_forward
from repro_torch.serve import (Engine, EngineReference, PagedEngine,
                               Request, mixed_requests, run_staggered,
                               staggered_groups)

ARCH = "whisper-tiny"
MAX_LEN = 40
SLOTS = 3
TOL = 1e-4


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _models():
    jcfg = jreduced(jget_config(ARCH), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(ARCH), dtype="float32")
    model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


# --- primitives ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 7, 64), (2, 384)])
def test_layer_norm_matches_jax(shape):
    x = _rand(shape, 0, 3.0) + 1.5
    g = _rand(shape[-1:], 1) + 1.0
    b = _rand(shape[-1:], 2)
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b))
    _close(got, want, 1e-6)


@pytest.mark.parametrize("length,dim", [(40, 64), (1536, 384), (7, 6)])
def test_sinusoidal_positions_bit_for_bit(length, dim):
    want = np.asarray(jcommon.sinusoidal_positions(length, dim))
    got = sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# --- the model ----------------------------------------------------------------


def test_param_names_shapes_and_init_rules():
    jmodel, jparams, model, params = _models()
    assert set(params) == set(jparams)
    assert tuple(params["pos/dec"].shape) == (MAX_LEN, model.cfg.d_model)
    fresh = model.init(torch.Generator().manual_seed(0))
    for n, p in fresh.items():
        assert tuple(p.shape) == jparams[n].shape, n
        np.testing.assert_array_equal(params[n].numpy(),
                                      np.asarray(jparams[n]))
        if n.endswith("/g") or n.endswith("/b"):
            fill = 1.0 if n.endswith("/g") else 0.0
            assert bool((p == fill).all()), n


@pytest.mark.parametrize("Se", [16, 40])
def test_encoder_forward_matches_jax(Se):
    jmodel, jparams, model, params = _models()
    frames = _rand((2, Se, model.cfg.d_model), 3)
    want = jencoder_forward(jmodel.cfg, jparams, jnp.asarray(frames))
    for impl in ("plain", "kernel"):
        _close(encoder_forward(model.cfg, params, torch.from_numpy(frames),
                               impl), want)


@pytest.mark.parametrize("source", ["frames", "enc_out"])
def test_prefill_matches_jax(source):
    """``Model.prefill`` with stub frames (the encoder runs first) or with a
    given encoder output: logits and the fresh per-layer K/V, both
    routes."""
    jmodel, jparams, model, params = _models()
    toks = _tokens(2, 11)
    src = _rand((2, 24, model.cfg.d_model), 4)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks),
                                      source: jnp.asarray(src)})
    for impl in ("plain", "kernel"):
        tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                        source: torch.from_numpy(src)},
                               attn_impl=impl)
        _close(tl, jl)
        assert set(tc) == set(jc) == {f"dec_{i}/{n}" for i in range(2)
                                      for n in ("k", "v")}
        for n in jc:
            _close(tc[n], jc[n])
    at = torch.tensor([10, 3])
    tl_at, _ = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                      source: torch.from_numpy(src)},
                             logits_at=at)
    _close(tl_at[:, 0], tl[torch.arange(2), at], 1e-6)


def _cache_with_enc(jmodel, B, seed):
    """A cache of random K/V and encoder rows, as numpy."""
    return {n: _rand(c.shape, seed + i, 0.3)
            for i, (n, c) in enumerate(sorted(
                jmodel.init_cache(B, MAX_LEN).items()))}


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_vector_position_decode_matches_jax(impl):
    """Per-row positions, the cross-attention reading each row's own
    ``enc/out``: logits and every bank against JAX over 6 ticks; K/V land
    at each row's position in place, ``enc/out`` passes through."""
    jmodel, jparams, model, params = _models()
    cache = _cache_with_enc(jmodel, 3, 10)
    jcache = {n: jnp.asarray(c) for n, c in cache.items()}
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    enc_before = tcache["enc/out"].clone()
    toks = _tokens(3, 6, seed=1)
    start = np.array([0, 5, 30], np.int32)
    for t in range(6):
        pos = start + t
        jl, jcache = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            jnp.asarray(pos))
        tl, new = model.decode_step(
            params, tcache, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            torch.from_numpy(pos), attn_impl=impl)
        assert new is tcache
        _close(tl, jl)
    assert set(tcache) == set(jcache)
    for n in jcache:
        _close(tcache[n], jcache[n])
    assert torch.equal(tcache["enc/out"], enc_before)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_scalar_position_decode_matches_jax_and_forward(impl):
    """Scalar positions with ``enc_out`` in the batch (the dry-run
    convention), 8 steps from a fresh cache: each step's logits within
    1e-4 of JAX's scalar ``decode_step`` and within 2e-3 of the
    full-sequence forward's (the mirror of JAX's
    ``test_whisper_decode_matches_forward``)."""
    _, _, model, params = _models()
    frames, toks, jfull, jsteps = _jax_scalar_decode()
    enc = encoder_forward(model.cfg, params, torch.from_numpy(frames))
    full, _ = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                     "enc_out": enc}, attn_impl="plain")
    _close(full, jfull)
    T = toks.shape[1]
    cache = {n: c for n, c in model.init_cache(2, T).items()
             if n != "enc/out"}
    for t in range(T):
        tl, cache = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                            "enc_out": enc}, torch.tensor(t),
            attn_impl=impl)
        _close(tl, jsteps[t])
        _close(tl[:, 0], full[:, t], 2e-3)


@functools.lru_cache(maxsize=None)
def _jax_scalar_decode(T=8):
    """JAX's full-sequence forward and scalar ``decode_step`` logits over
    ``T`` tokens against a 16-frame encoder output (jitted: the step
    position is traced)."""
    jmodel, jparams, model, _ = _models()
    frames = _rand((2, 16, model.cfg.d_model), 3)
    toks = _tokens(2, T, seed=2)
    jenc = jencoder_forward(jmodel.cfg, jparams, jnp.asarray(frames))
    jfull, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                           "enc_out": jenc}, mode="train",
                                 attn_impl="naive")
    step = jax.jit(lambda c, b, pos: jmodel.decode_step(jparams, c, b, pos))
    jcache = jmodel.init_cache(2, T)
    steps = []
    for t in range(T):
        jl, jcache = step(jcache, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                   "enc_out": jenc}, t)
        steps.append(np.asarray(jl))
    return frames, toks, np.asarray(jfull), steps


def test_encode_prompt_matches_jax():
    jmodel, jparams, model, params = _models()
    toks = _tokens(3, MAX_LEN, seed=5)
    lens = np.array([3, MAX_LEN, 0], np.int32)
    want = jmodel.encode_prompt(jparams, jnp.asarray(toks),
                                jnp.asarray(lens))
    got = model.encode_prompt(params, torch.from_numpy(toks),
                              torch.from_numpy(lens))
    _close(got, want)
    with pytest.raises(ValueError, match="encdec-only"):
        build_model(reduced(get_config("llama3-8b")), device="cpu"
                    ).encode_prompt(params, torch.from_numpy(toks),
                                    torch.from_numpy(lens))


def test_state_banks_key_exactly_like_the_cache():
    jmodel, _, model, _ = _models()
    banks = model.state_banks()
    defs = model.cache_defs(SLOTS, 16)
    jdefs = jmodel.cache_defs(SLOTS, 16)
    assert set(banks) == set(defs) == set(jdefs)
    for n, b in banks.items():
        assert isinstance(b, StateBank) and b.name == n
        assert defs[n].shape == jdefs[n].shape
        assert defs[n].shape[b.batch_axis] == SLOTS
        jb = jmodel.state_banks()[n]
        assert (b.kind, b.batch_axis, b.seq_axis) == \
            (jb.kind, jb.batch_axis, jb.seq_axis)
    assert banks["enc/out"].kind == "enc"
    assert {b.kind for b in banks.values()} == {"kv", "enc"}
    assert "enc" in api.BANK_KINDS
    StateBank("x", "enc", batch_axis=0)
    assert model.serve_modes == frozenset({"dense"})


def test_paged_refusals():
    _, _, model, params = _models()
    with pytest.raises(UnsupportedFamilyError, match="'encdec'") as ei:
        PagedEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                    device="cpu")
    assert ei.value.family == "encdec"
    with pytest.raises(ValueError, match="not supported"):
        model.paged_cache_defs(9, 8)
    with pytest.raises(ValueError, match="encoder-output bank"):
        model.decode_step(params, model.init_cache(1, 8),
                          {"tokens": torch.zeros(1, 1, dtype=torch.int32)},
                          torch.zeros(1, dtype=torch.int32),
                          page_table=torch.zeros(1, 1, dtype=torch.int32))


def test_engines_refuse_max_len_past_the_positions():
    _, _, model, params = _models()
    for cls in (Engine, EngineReference):
        with pytest.raises(ValueError, match="max_seq"):
            cls(model, params, slots=SLOTS, max_len=MAX_LEN + 8,
                device="cpu")


def test_input_specs_and_make_inputs_match_jax():
    for name, shape in SHAPES.items():
        got = input_specs(get_config(ARCH), shape)
        want = jinput_specs(jget_config(ARCH), JSHAPES[name])
        assert list(got) == list(want)
        for n, (shp, dt) in got.items():
            assert shp == want[n].shape, (name, n)
            assert str(dt).split(".")[-1] == want[n].dtype.name
    assert input_specs(get_config(ARCH), SHAPES["decode_32k"])[
        "enc_out"][0][1] == WHISPER_DECODE_ENC_LEN == 1536
    cfg = reduced(get_config(ARCH))
    for kind in ("train", "prefill", "decode"):
        small = dataclasses.replace(
            next(s for s in SHAPES.values() if s.kind == kind),
            seq_len=16, global_batch=2)
        a = make_inputs(cfg, small, torch.Generator().manual_seed(3),
                        device="cpu")
        b = make_inputs(cfg, small, torch.Generator().manual_seed(3),
                        device="cpu")
        assert list(a) == list(input_specs(cfg, small))
        for n, t in a.items():
            assert torch.equal(t, b[n])
            assert tuple(t.shape) == input_specs(cfg, small)[n][0]
            assert t.dtype == input_specs(cfg, small)[n][1]


def test_dry_run_decode_cell_runs_on_make_inputs():
    """The decode cell's operands (tokens and a 1536-frame ``enc_out``)
    through a scalar ``decode_step`` on a fresh cache."""
    _, _, model, params = _models()
    cfg = model.cfg
    cell = dataclasses.replace(SHAPES["decode_32k"], seq_len=16,
                               global_batch=2)
    batch = make_inputs(cfg, cell, torch.Generator().manual_seed(0),
                        device="cpu")
    cache = {n: c for n, c in model.init_cache(2, 16).items()
             if n != "enc/out"}
    lg, _ = model.decode_step(params, cache, batch, 15, attn_impl="kernel")
    assert lg.shape == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(lg).all())


# --- serving ------------------------------------------------------------------


def _workload(seed=5, n=6):
    return mixed_requests(n, seed=seed, vocab=512, prompt_lens=(2, 9),
                          max_new=(2, 8))


@functools.lru_cache(maxsize=None)
def _jax_reference():
    """The JAX EngineReference on ``tests/test_serve_families.py``'s
    staggered, uneven workload, with its eos probe."""
    jmodel, jparams, _, _ = _models()

    def work():
        return jmixed_requests(6, seed=5, vocab=512, prompt_lens=(2, 9),
                               max_new=(2, 8))

    ref = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN)
    probe = jrun_staggered(ref, jstaggered_groups(work(), 2))
    eos = next(t for o in probe.values() for t in o[1:])
    ref = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                           eos_id=eos)
    return probe, eos, jrun_staggered(ref, jstaggered_groups(work(), 2))


def test_engine_reference_parity_vs_jax():
    _, _, model, params = _models()
    probe, eos, with_eos = _jax_reference()
    assert any(o[-1] == eos and len(o) > 1 for o in with_eos.values()), \
        "workload must exercise an eos exit"
    for eos_id, want in ((None, probe), (eos, with_eos)):
        ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                              eos_id=eos_id, device="cpu")
        assert run_staggered(ref, staggered_groups(_workload(), 2)) == want


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("prefill", ["plain", "kernel"])
def test_engine_parity_vs_jax_staggered_uneven_eos(K, prefill):
    """Staggered arrivals, uneven lengths, eos exits: the port's Engine
    emits the JAX reference's tokens, token for token, with either
    prefill route."""
    _, _, model, params = _models()
    _, eos, with_eos = _jax_reference()
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN, eos_id=eos,
                 ticks_per_sync=K, prefill_attn_impl=prefill, device="cpu")
    out = run_staggered(eng, staggered_groups(_workload(), 2))
    assert out == with_eos, f"K={K}"


def test_enc_bank_rows_isolated_and_bitwise_across_engines():
    """Admitting a request writes only its slot's ``enc/out`` row (the
    mirror of ``test_encdec_enc_bank_row_isolated``), equal to the JAX
    engine's row within 1e-4 and to the port's ``EngineReference``'s bit
    for bit; a second admission into another slot leaves the first row's
    bits."""
    jmodel, jparams, model, params = _models()
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=1, record_traffic=False, device="cpu")
    eng.submit(Request(uid=0, prompt=[5, 7, 11], max_new_tokens=4))
    eng._admit()
    enc = eng.cache["enc/out"].clone()
    assert float(enc[0].abs().sum()) > 0
    assert bool((enc[1:] == 0).all())

    jeng = JEngine(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                   ticks_per_sync=1, record_traffic=False)
    jeng.submit(JRequest(uid=0, prompt=[5, 7, 11], max_new_tokens=4))
    jeng._admit()
    _close(enc, jeng.cache["enc/out"])

    ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                          device="cpu")
    ref._prefill(0, Request(uid=0, prompt=[5, 7, 11], max_new_tokens=4))
    assert torch.equal(ref.cache["enc/out"][0], enc[0])

    eng.submit(Request(uid=1, prompt=[9, 8, 7, 6, 5], max_new_tokens=4))
    eng._admit()
    after = eng.cache["enc/out"]
    assert torch.equal(after[0], enc[0])
    assert float(after[1].abs().sum()) > 0 and bool((after[2] == 0).all())
    ref._prefill(1, Request(uid=1, prompt=[9, 8, 7, 6, 5],
                            max_new_tokens=4))
    assert torch.equal(ref.cache["enc/out"][:2], after[:2])


def test_requeued_request_is_encoded_again_and_resumes():
    """A preempted request re-admits from ``prompt + output``: its
    ``enc/out`` row is encoded from that, and the greedy continuation
    equals an uninterrupted run."""
    _, _, model, params = _models()
    alone = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                   ticks_per_sync=2, device="cpu")
    ra = Request(uid=0, prompt=[5, 7, 11, 13], max_new_tokens=10)
    alone.submit(ra)
    alone.run()
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    a = Request(uid=0, prompt=list(ra.prompt), max_new_tokens=10)
    eng.submit(a)
    eng.step()
    eng.preempt_slot(0)
    eff = a.prompt + a.output
    eng._admit()
    want = model.encode_prompt(
        params, torch.tensor([eff + [0] * (MAX_LEN - len(eff))] * SLOTS),
        torch.tensor([len(eff)] * SLOTS))[0]
    _close(eng.cache["enc/out"][0], want, 1e-6)
    eng.run()
    assert a.output == ra.output


def test_records_launches_and_the_uncounted_encoder():
    """Records are ``serve_encdec_*``; the counted decode window holds
    each layer's decode kernel and cross-attention flash call and one
    sampler call a tick; the counted prefill holds the sampler alone: the
    encoder's flash calls run before it, uncounted.  On CPU tensors the
    wrappers launch nothing."""
    _, _, model, params = _models()
    ops.reset_launches()
    K, L = 2, model.cfg.dec_layers
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=K, device="cpu")
    for r in _workload(seed=3, n=4):
        eng.submit(r)
    assert eng.run() == 0
    recs = eng.serve_records()
    assert recs and all(r["shape"].startswith("serve_encdec_")
                        and r["family"] == "encdec" for r in recs)
    assert eng._traffic["decode"].kernel_calls == {
        "decode_attention": L * K, "flash_attention": L * K,
        "fused_sample": K}
    for stats in eng._traffic["prefill"].values():
        assert stats.kernel_calls == {"fused_sample": 1}
    assert all(v == 0 for v in ops.launches.values())
    assert [v.shape for v in eng.nvm_verdicts()] == [r["shape"]
                                                      for r in recs]


def test_launcher_serves_whisper_on_cpu(capsys, monkeypatch):
    launch_serve.main(["--device", "cpu", "--arch", ARCH])
    out = capsys.readouterr().out
    assert "served 8 requests" in out and "terminal states: DONE=8" in out
    assert "  serve_encdec_decode_b4_l64: energy vs SRAM" in out
    assert "  serve_encdec_prefill_p" in out
    launch_serve.main(["--list-configs"])
    assert f"{ARCH:<22} {'encdec':<8} Engine, EngineReference\n" in \
        capsys.readouterr().out

    def no_weights(*a, **k):
        raise AssertionError("weights were made")

    monkeypatch.setattr(api.Model, "init", no_weights)
    with pytest.raises(UnsupportedFamilyError, match="encdec"):
        launch_serve.main(["--device", "cpu", "--arch", ARCH, "--paged"])
