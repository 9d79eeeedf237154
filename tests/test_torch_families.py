"""The port's ssm (mamba2) and hybrid (recurrentgemma) families against the
JAX package, on the CPU: the two scans' plain versions against the Pallas
kernels (interpret mode) and their oracles, the blocks and the model's
prefill/decode against JAX with the same weights
(``model.init(PRNGKey(0))`` through ``params_from_numpy``), and the serve
engines token for token against the JAX ``EngineReference`` on the cases
of ``tests/test_serve_families.py``.

Tolerances: the scans' plain versions are held to the JAX kernel tests'
bounds (``tests/test_kernels.py``: ssd f32 5e-4 / bf16 5e-2; rglru f32
1e-4 / bf16 3e-2); blocks, prefill and decode to 1e-4 in f32 (sums in
another order than XLA's; the RG-LRU recurrence is sequential here and
an associative scan there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.serve import EngineReference as JEngineReference
from repro.serve import mixed_requests as jmixed_requests
from repro.serve import run_staggered as jrun_staggered
from repro.serve import staggered_groups as jstaggered_groups
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import build_model, rglru, ssm
from repro_torch.models.api import StateBank
from repro_torch.models.common import subtree
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (Engine, EngineReference, Request,
                               mixed_requests, run_staggered,
                               staggered_groups)

ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
MAX_LEN = 40
SLOTS = 3
TOL = 1e-4


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jreduced(jget_config(arch), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch), dtype="float32")
    model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


# --- the SSD scan ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (1, 2, 64, 16, 8, 16),
    (2, 4, 128, 32, 16, 32),
    (1, 1, 64, 64, 32, 64),   # single chunk
])
def test_ssd_scan_plain_matches_pallas_and_oracle(dtype, B, H, S, P, N,
                                                  chunk):
    """The plain version (model layout) against the Pallas kernel in
    interpret mode and ``ref.ssd_scan_ref`` (head-major layout) on the
    shapes and bounds of ``tests/test_kernels.py::test_ssd_scan_sweep``."""
    rng = np.random.default_rng(1)
    x = _rand(rng, (B, H, S, P))
    dt = np.log1p(np.exp(_rand(rng, (B, H, S))))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32) * 0.3
    dtA = dt * A[None, :, None]
    Bm, Cm = _rand(rng, (B, S, N)), _rand(rng, (B, S, N))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [_j(a, jd) for a in (x, dt, dtA, Bm, Cm)]
    pallas = jops.ssd_scan(*jargs, chunk=chunk)
    oracle = jref.ssd_scan_ref(*jargs)

    def model_layout(a):             # (B,H,S,...) -> (B,S,H,...)
        return _t(a, td).transpose(1, 2).contiguous()

    y, s = ssd.ssd_scan_plain(model_layout(jargs[0]), model_layout(jargs[1]),
                              model_layout(jargs[2]), _t(jargs[3], td),
                              _t(jargs[4], td), chunk=chunk)
    assert y.dtype == td and s.dtype == torch.float32
    assert s.shape == (B, H, P, N)
    tol = 5e-4 if dtype == "float32" else 5e-2
    got = y.transpose(1, 2)
    _close(got, pallas, tol)
    _close(got, oracle, tol)


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 48)])
def test_ssd_scan_plain_carries_a_nonzero_state(S, chunk):
    """With an initial state: y and the final state against the JAX
    ``ssd_chunked`` (model layout, f32)."""
    rng = np.random.default_rng(2)
    b, H, P, N = 2, 3, 8, 16
    x = _rand(rng, (b, S, H, P))
    dt = np.log1p(np.exp(_rand(rng, (b, S, H))))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32) * 0.3
    Bm, Cm = _rand(rng, (b, S, N)), _rand(rng, (b, S, N))
    s0 = _rand(rng, (b, H, P, N))
    jy, js = jssm.ssd_chunked(_j(x), _j(dt), _j(A), _j(Bm), _j(Cm), chunk,
                              initial_state=_j(s0))
    y, s = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                           initial_state=_t(s0))
    _close(y, jy, 5e-4)
    _close(s, js, 5e-4)


def test_ssd_scan_chunk_must_divide_s():
    z = torch.zeros
    with pytest.raises(ValueError, match=r"chunk 24 must divide .* S = 64"):
        ssd.ssd_scan_plain(z(1, 64, 2, 4), z(1, 64, 2), z(1, 64, 2),
                           z(1, 64, 8), z(1, 64, 8), chunk=24)


# --- the RG-LRU scan ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R,block,wt", [
    (1, 128, 128, 32, 64),
    (2, 256, 256, 64, 128),
    (1, 64, 512, 64, 512),
])
def test_rglru_scan_plain_matches_pallas_and_oracle(dtype, B, S, R, block,
                                                    wt):
    """On the shapes and bounds of ``tests/test_kernels.py::
    test_rglru_scan_sweep``: the inputs rounded to ``dtype`` as there, the
    plain version's f32 output against the Pallas kernel and
    ``ref.rglru_scan_ref``."""
    rng = np.random.default_rng(3)
    a = 1 / (1 + np.exp(-_rand(rng, (B, S, R))))
    b = _rand(rng, (B, S, R), 0.1)
    jd = getattr(jnp, dtype)
    ja, jb = _j(a, jd), _j(b, jd)
    pallas = jops.rglru_scan(ja, jb, block=block, width_tile=wt)
    oracle = jref.rglru_scan_ref(ja, jb)
    y, h = rg.rglru_scan_plain(_t(ja), _t(jb))
    assert y.dtype == torch.float32 and h.shape == (B, R)
    assert torch.equal(h, y[:, -1])
    tol = 1e-4 if dtype == "float32" else 3e-2
    _close(y.to(getattr(torch, dtype)), pallas, tol)
    _close(y.to(getattr(torch, dtype)), oracle, tol)


@pytest.mark.parametrize("S", [1, 40, 256, 512])
def test_rglru_model_scan_with_h0_matches_jax(S):
    """``models.rglru.rglru_scan`` (gates + recurrence) with h0 against the
    JAX ``rglru_scan``: its associative branch (S <= 256) and its blocked
    branch (S = 512)."""
    rng = np.random.default_rng(4)
    B, R = 2, 16
    x = _rand(rng, (B, S, R))
    r = 1 / (1 + np.exp(-_rand(rng, (B, S, R))))
    i = 1 / (1 + np.exp(-_rand(rng, (B, S, R))))
    lam = _rand(rng, (R,))
    h0 = _rand(rng, (B, R))
    jy, jh = jrglru.rglru_scan(_j(x), _j(r), _j(i), _j(lam), _j(h0))
    for impl in ("plain", "kernel"):
        y, h = rglru.rglru_scan(_t(x), _t(r), _t(i), _t(lam), _t(h0),
                                impl=impl)
        _close(y, jy)
        _close(h, jh)


# --- blocks and the model ----------------------------------------------------


def _block_inputs(cfg, S, seed=5):
    return _rand(np.random.default_rng(seed), (2, S, cfg.d_model))


@pytest.mark.parametrize("S", [1, 12, 64])
def test_ssm_block_matches_jax(S):
    """Sequence branch (no state; S = 64 is two chunks) and, at S = 1 with
    a state, the recurrent decode branch."""
    jmodel, jparams, model, params = _models("mamba2-1.3b")
    cfg = model.cfg
    jp = {k[len("blocks/ssm/"):]: v[0] for k, v in jparams.items()
          if k.startswith("blocks/ssm/")}
    tp = {k: v[0] for k, v in subtree(params, "blocks/ssm").items()}
    u = _block_inputs(cfg, S)
    jstate = tstate = None
    if S == 1:
        rng = np.random.default_rng(6)
        c = jmodel.cache_defs(2, 8)
        conv = _rand(rng, c["conv"].shape[1:])
        s = _rand(rng, c["ssm"].shape[1:])
        jstate = {"conv": _j(conv), "ssm": _j(s)}
        tstate = {"conv": _t(conv), "ssm": _t(s)}
    jo, jst = jssm.ssm_block(jmodel.cfg, jp, _j(u), state=jstate)
    to, tst = ssm.ssm_block(cfg, tp, _t(u), state=tstate)
    _close(to, jo)
    if jst is not None:
        for n in ("conv", "ssm"):
            _close(tst[n], jst[n])


@pytest.mark.parametrize("S", [1, 12, 300])
def test_rglru_block_matches_jax(S):
    """Padded-conv branch without a state (S = 300: the JAX scan's blocked
    branch is not taken, 300 % 256 != 0) and the decode-window branch."""
    jmodel, jparams, model, params = _models("recurrentgemma-2b")
    cfg = model.cfg
    pre = "layer_0/rec/"
    jp = {k[len(pre):]: v for k, v in jparams.items() if k.startswith(pre)}
    tp = subtree(params, "layer_0/rec")
    u = _block_inputs(cfg, S)
    jstate = tstate = None
    if S == 1:
        rng = np.random.default_rng(7)
        h = _rand(rng, (2, cfg.lru_width))
        conv = _rand(rng, (2, 3, cfg.lru_width))
        jstate, tstate = ({"h": _j(h), "conv": _j(conv)},
                          {"h": _t(h), "conv": _t(conv)})
    jo, jst = jrglru.rglru_block(jmodel.cfg, jp, _j(u), state=jstate)
    to, tst = rglru.rglru_block(cfg, tp, _t(u), state=tstate)
    _close(to, jo)
    if jst is not None:
        for n in ("h", "conv"):
            _close(tst[n], jst[n])


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [11, 64])
def test_prefill_logits_and_cache_match_jax(arch, S):
    jmodel, jparams, model, params = _models(arch)
    toks = _tokens(2, S)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    assert set(tc) == set(jc)
    for n in jc:
        assert tc[n].dtype == getattr(torch, str(jc[n].dtype)), n
        _close(tc[n], jc[n])
    at = torch.tensor([S - 1, 3])
    tl_at, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                             logits_at=at)
    _close(tl_at[:, 0], tl[torch.arange(2), at], 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_vector_position_decode_matches_jax(arch, impl):
    """Per-row positions (rows at different depths), 12 ticks from a fresh
    cache: logits and every cache bank against JAX; the cache passed in
    keeps its bits."""
    jmodel, jparams, model, params = _models(arch)
    toks = _tokens(3, 12, seed=1)
    start = np.array([0, 5, 27], np.int32)
    jcache = jmodel.init_cache(3, MAX_LEN)
    cache = model.init_cache(3, MAX_LEN)
    for t in range(12):
        pos = start + t
        jl, jcache = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            jnp.asarray(pos))
        before = {n: c.clone() for n, c in cache.items()}
        tl, new = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            torch.from_numpy(pos), attn_impl=impl)
        assert all(torch.equal(cache[n], before[n]) for n in cache)
        cache = new
        _close(tl, jl)
    assert set(cache) == set(jcache)
    for n in jcache:
        _close(cache[n], jcache[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_per_token_decode(arch):
    """``Model.prefill`` over S = 64 (two 32-token SSD chunks for mamba2)
    against the per-token ``decode_step`` loop: last-position logits and
    the final recurrent state within 2e-3, the JAX decode-vs-forward bound
    (``tests/test_models.py``)."""
    _, _, model, params = _models(arch)
    toks = torch.from_numpy(_tokens(2, 64, seed=2))
    lg, pc = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(2, 64)
    for t in range(64):
        dl, cache = model.decode_step(
            params, cache, {"tokens": toks[:, t:t + 1]},
            torch.full((2,), t, dtype=torch.int32), attn_impl="kernel")
    _close(dl[:, 0], lg[:, -1], 2e-3)
    name = "ssm" if arch == "mamba2-1.3b" else "rec/h"
    _close(cache[name], pc[name], 2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_banks_key_exactly_like_the_cache(arch):
    _, _, model, _ = _models(arch)
    banks = model.state_banks()
    defs = model.cache_defs(SLOTS, 16)
    assert set(banks) == set(defs)
    for n, b in banks.items():
        assert isinstance(b, StateBank) and b.name == n
        assert defs[n].shape[b.batch_axis] == SLOTS
        assert b.kind in ("recurrent", "ring")
        if b.kind == "ring":
            assert b.seq_axis is not None and defs[n].shape[b.seq_axis] <= 16
    cache = model.init_cache(SLOTS, 16)
    if arch == "recurrentgemma-2b":
        assert cache["attn/pos"].dtype == torch.int32
        assert bool((cache["attn/pos"] == -1).all())
        assert cache["rec/h"].dtype == torch.float32
    else:
        assert cache["ssm"].dtype == torch.float32


def test_statebank_contract_validation():
    with pytest.raises(ValueError, match="kind"):
        StateBank("x", "paged", batch_axis=0)
    with pytest.raises(ValueError, match="batch_axis"):
        StateBank("x", "ring", batch_axis=2, seq_axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_jax_init_rules(arch):
    _, jparams, model, _ = _models(arch)
    params = model.init(torch.Generator().manual_seed(0))
    assert set(params) == set(jparams)
    consts = {"A_log": 0.0, "D_skip": 1.0, "lam": 1.0, "dt_bias": 0.0,
              "conv_b": 0.0}
    for n, p in params.items():
        assert tuple(p.shape) == jparams[n].shape, n
        leaf = n.rsplit("/", 1)[-1]
        if leaf in consts:
            assert bool((p == consts[leaf]).all()), n


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_and_page_table_refused(arch):
    _, _, model, params = _models(arch)
    with pytest.raises(ValueError, match="not supported"):
        model.paged_cache_defs(9, 8)
    with pytest.raises(ValueError, match="recurrent state"):
        model.decode_step(params, model.init_cache(1, 8),
                          {"tokens": torch.zeros(1, 1, dtype=torch.int32)},
                          torch.zeros(1, dtype=torch.int32),
                          page_table=torch.zeros(1, 1, dtype=torch.int32))


# --- serving -----------------------------------------------------------------


def _workload(seed=5, n=6):
    return mixed_requests(n, seed=seed, vocab=512, prompt_lens=(2, 9),
                          max_new=(2, 8))


@functools.lru_cache(maxsize=None)
def _jax_reference(arch):
    """The JAX EngineReference on ``tests/test_serve_families.py``'s
    staggered, uneven workload, with its eos probe."""
    jmodel, jparams, _, _ = _models(arch)

    def work():
        return jmixed_requests(6, seed=5, vocab=512, prompt_lens=(2, 9),
                               max_new=(2, 8))

    ref = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN)
    probe = jrun_staggered(ref, jstaggered_groups(work(), 2))
    eos = next(t for o in probe.values() for t in o[1:])
    ref = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                           eos_id=eos)
    return probe, eos, jrun_staggered(ref, jstaggered_groups(work(), 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_reference_parity_vs_jax(arch):
    _, _, model, params = _models(arch)
    probe, eos, with_eos = _jax_reference(arch)
    assert any(o[-1] == eos and len(o) > 1 for o in with_eos.values()), \
        "workload must exercise an eos exit"
    for eos_id, want in ((None, probe), (eos, with_eos)):
        ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                              eos_id=eos_id, device="cpu")
        assert run_staggered(ref, staggered_groups(_workload(), 2)) == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("K", [1, 4])
def test_engine_parity_vs_jax_staggered_uneven_eos(arch, K):
    """Staggered arrivals, uneven lengths, eos exits: the port's Engine
    emits the JAX reference's tokens, token for token."""
    _, _, model, params = _models(arch)
    _, eos, with_eos = _jax_reference(arch)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN, eos_id=eos,
                 ticks_per_sync=K, device="cpu")
    out = run_staggered(eng, staggered_groups(_workload(), 2))
    assert out == with_eos, f"{arch} K={K}"
    assert eng.counts["prefill_steps"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_guarded_rows_at_reset_after_a_drain(arch):
    """After every request drains, each guarded bank row sits at its reset
    value (-1 for the ring positions, 0 elsewhere)."""
    _, _, model, params = _models(arch)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    for r in _workload(seed=3, n=5):
        eng.submit(r)
    assert eng.run() == 0
    assert eng._guarded == set(eng.cache)
    for n, c in eng.cache.items():
        assert bool((c == eng._bank_reset[n]).all()), n
    assert eng._bank_reset.get("attn/pos", -1) == -1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_scan_leaves_other_slots_bitwise(arch):
    """An admission's prefill scan writes the admitted slot's rows only:
    a slot mid-decode and a free slot keep their bits, and the mid-decode
    request ends as it would alone."""
    _, _, model, params = _models(arch)
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
    gen = torch.Generator().manual_seed(3)
    free = 2
    for c in eng.cache.values():        # noise in the free slot's rows
        row = c.narrow(1, free, 1)
        row.copy_(torch.randint(-5, 5, row.shape, generator=gen))
    before = {n: c.clone() for n, c in eng.cache.items()}
    eng.submit(Request(uid=1, prompt=[101, 102, 103], max_new_tokens=4))
    eng._admit()                                  # lands in slot 1
    for n, c in eng.cache.items():
        assert torch.equal(c[:, [0, 2]], before[n][:, [0, 2]]), n
        assert not torch.equal(c[:, 1], before[n][:, 1]), n
    eng.run()
    assert a.output == ra.output


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_launch_counts_on_cpu_stay_zero(arch):
    """On CPU tensors the wrappers take the plain versions and count no
    launch; the engine counts its prefill-scan steps."""
    _, _, model, params = _models(arch)
    ops.reset_launches()
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=3))
    eng.run()
    assert eng.counts["prefill_steps"] == 5
    assert all(v == 0 for v in ops.launches.values())
