"""The port's attention paths against the JAX package's, on the CPU: the
flash wrapper's plain version with a query offset, a valid-key length,
non-causal masks and windows; ``chunked_attention``'s forward and
gradients with those arguments and with bf16 probabilities;
``naive_attention`` over explicit key positions; ``attention_block``
non-causal and with a cross-attention source; scalar-position
``decode_step`` of every family the port serves; ``Model.prefill`` through
the flash route; and the small parity gaps (``simulate_capacity``,
``engine_reference``).  Inputs are made with numpy from a seed, weights
come from the JAX package's ``model.init`` through ``params_from_numpy``.

Tolerances: the JAX tests' (f32 2e-5 for attention outputs, lse 1e-5,
gradients rtol 3e-4 / atol 3e-5 as ``tests/test_models.py``'s
``test_flash_vjp_matches_naive``, decode against the forward 2e-3 as its
``test_decode_matches_forward``, prefill logits and caches 1e-4 as
``tests/test_torch_models.py``).  With ``p_bf16`` the JAX forward also
rounds V and each block's product to bf16, where the port (and its CUDA
kernel) rounds only P: the outputs are held to bf16's 2e-2, dv (which
sees only the rounded P, the same in both) to 3e-4 / 3e-5, and dq, dk
(which see the forward's output through ``delta = sum(do * out)``) to
2e-2; the backward rule itself, fed the same residuals, to 3e-4 / 3e-5.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core import cachesim as jcachesim  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import cachesim  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import (FlashAttention,  # noqa: E402
                                          attention_block,
                                          chunked_attention, naive_attention)
from repro_torch.models.common import rope_tables  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402

KV_BLOCK = 16
# (name, Sq, Skv, causal, window, cap, q_offset, kv_len, gqa)
CASES = [
    ("decode", 1, 64, True, 0, 0.0, 37, 38, 4),
    ("decode_first_key", 1, 64, True, 0, 0.0, 0, 1, 2),
    ("decode_window_cap", 1, 64, True, 16, 30.0, 50, 51, 2),
    ("offset_chunk", 16, 64, True, 0, 0.0, 40, 56, 2),
    ("offset_chunk_window", 8, 48, True, 12, 50.0, 30, 38, 1),
    ("noncausal_kv_len", 24, 64, False, 0, 0.0, 0, 45, 2),
    ("noncausal_window_offset", 20, 64, False, 24, 0.0, 20, 64, 2),
]
IDS = [c[0] for c in CASES]


def _inputs(Sq, Skv, gqa, seed=0, B=2, K=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, K * gqa, hd), (B, Skv, K, hd), (B, Skv, K, hd),
                      (B, Sq, K * gqa, hd))]


def _jkw(causal, window, cap, q_offset, kv_len):
    return dict(causal=causal, window=window, logit_cap=cap,
                q_offset=q_offset, kv_len=kv_len)


def _close(t, j, tol, what=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


# --- the flash wrapper's plain version ---------------------------------------


@pytest.mark.parametrize("name,Sq,Skv,causal,window,cap,q_offset,kv_len,gqa",
                         CASES, ids=IDS)
def test_flash_plain_with_offsets_matches_jax(name, Sq, Skv, causal, window,
                                              cap, q_offset, kv_len, gqa):
    """``ops.flash_attention`` on CPU tensors (the plain version, Pallas
    layout) against JAX's ``chunked_attention`` and ``naive_attention``
    with the same query offset, valid-key length and mask; lse against
    ``_flash_fwd_scan``'s."""
    q, k, v, _ = _inputs(Sq, Skv, gqa)
    kw = _jkw(causal, window, cap, q_offset, kv_len)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    chunked = jattention.chunked_attention(jq, jk, jv, kv_block=KV_BLOCK,
                                           **kw)
    naive = jattention.naive_attention(jq, jk, jv, **kw)
    _, jlse = jattention._flash_fwd_scan(
        jq, jk, jv, jnp.float32(window), jnp.float32(q_offset),
        jnp.float32(kv_len), causal, cap, KV_BLOCK)
    tq, tk, tv = (torch.from_numpy(x).transpose(1, 2) for x in (q, k, v))
    got, lse = ops.flash_attention(tq, tk, tv, return_lse=True, **kw)
    assert ops.launches["flash_attention"] == 0      # CPU: the plain version
    _close(got.transpose(1, 2), chunked, 2e-5, "vs chunked_attention")
    _close(got.transpose(1, 2), naive, 2e-5, "vs naive_attention")
    _close(lse.transpose(1, 2).reshape(jlse.shape), jlse, 1e-5, "lse")


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    """On CPU tensors as on the card: positions must be host ints in range,
    ``p_bf16`` a bool, and no query row may be left without a live key."""
    q = torch.zeros(1, 2, 4, 16)
    k = torch.zeros(1, 2, 32, 16)
    bad = [dict(q_offset=torch.tensor(3)), dict(kv_len=torch.tensor(8)),
           dict(q_offset=-1), dict(kv_len=0), dict(kv_len=33),
           dict(q_offset=2.0), dict(p_bf16=1), dict(window=-2),
           dict(causal=1),
           # rows 2, 3 (positions 30, 31) see no key below kv_len 24 - 8
           dict(window=8, q_offset=28, kv_len=24)]
    for kw in bad:
        with pytest.raises(ValueError):
            ops.flash_attention(q, k, k, **kw)
        args = dict(causal=True, window=0, q_offset=0, kv_len=None,
                    p_bf16=False)
        args.update(kw)
        with pytest.raises(ValueError):
            fa.check_args(q, k, k, args.pop("causal"), args.pop("window"),
                          0.0, **args)
    with pytest.raises(ValueError, match="no key"):
        ops.flash_attention(q, k, k, window=8, q_offset=28, kv_len=24)
    ops.flash_attention(q, k, k, window=8, q_offset=27, kv_len=32)
    fa.check_args(q, k, k, True, 8, 0.0, 27, 32, True)
    assert ops.launches["flash_attention"] == 0


# --- chunked_attention: forward and gradients --------------------------------


@pytest.mark.parametrize("name,Sq,Skv,causal,window,cap,q_offset,kv_len,gqa",
                         CASES, ids=IDS)
def test_chunked_attention_grads_match_jax(name, Sq, Skv, causal, window,
                                           cap, q_offset, kv_len, gqa):
    """``chunked_attention`` (``FlashAttention``: plain forward on the CPU,
    blockwise backward) against ``jax.grad`` of JAX's ``chunked_attention``
    with the same offset, kv_len and mask; dead keys get exactly zero dk
    and dv."""
    q, k, v, do = _inputs(Sq, Skv, gqa, seed=1)
    kw = _jkw(causal, window, cap, q_offset, kv_len)

    def jf(q, k, v):
        return (jattention.chunked_attention(q, k, v, kv_block=KV_BLOCK, **kw)
                * do).sum()

    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to = chunked_attention(*ts, kv_block=KV_BLOCK, **kw)
    tl = (to * torch.from_numpy(do)).sum()
    tg = torch.autograd.grad(tl, ts)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-5,
                               atol=2e-5)
    for a, b, n in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-5, err_msg=f"d{n}")
    for g in tg[1:]:
        assert bool((g[:, kv_len:] == 0).all())


P_BF16_CASES = [c for c in CASES if c[0] in ("decode_window_cap",
                                             "offset_chunk",
                                             "noncausal_kv_len")]


@pytest.mark.parametrize("name,Sq,Skv,causal,window,cap,q_offset,kv_len,gqa",
                         P_BF16_CASES, ids=[c[0] for c in P_BF16_CASES])
def test_p_bf16_matches_jax(name, Sq, Skv, causal, window, cap, q_offset,
                            kv_len, gqa):
    """``p_bf16`` (JAX's ``impl="chunked_bf16"``) on f32 inputs: forward and
    gradients against ``jax.grad`` (bounds in the module docstring), and
    the backward rule on the same residuals (q, k, v, o, lse) against JAX's
    ``_flash_bwd_rule`` at the f32 bounds."""
    q, k, v, do = _inputs(Sq, Skv, gqa, seed=2)
    kw = _jkw(causal, window, cap, q_offset, kv_len)

    def jf(q, k, v):
        return (jattention.chunked_attention(q, k, v, kv_block=KV_BLOCK,
                                             p_bf16=True, **kw) * do).sum()

    jo = jattention.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                      kv_block=KV_BLOCK, p_bf16=True, **kw)
    jg = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    to = chunked_attention(*ts, kv_block=KV_BLOCK, p_bf16=True, **kw)
    tg = torch.autograd.grad((to * torch.from_numpy(do)).sum(), ts)
    _close(to, jo, 2e-2, "forward")
    plain = chunked_attention(*(t.detach() for t in ts), kv_block=KV_BLOCK,
                              **kw)
    assert not torch.equal(to.detach(), plain)      # P was rounded
    for a, b, n, tol in zip(tg, jg, "qkv", (2e-2, 2e-2, None)):
        if tol is None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                       atol=3e-5, err_msg="dv")
        else:
            _close(a, b, tol, f"d{n}")

    # the backward rule alone, on the port's forward residuals
    tq, tk, tv = (t.detach() for t in ts)
    o, lse = ops.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                 tv.transpose(1, 2), p_bf16=True,
                                 return_lse=True, **kw)
    o = o.transpose(1, 2)
    ctx = types.SimpleNamespace(
        saved_tensors=(tq, tk, tv, o, lse),
        cfg=(causal, window, cap, KV_BLOCK, q_offset, kv_len, True))
    got = FlashAttention.backward(ctx, torch.from_numpy(do))[:3]
    B, H, hd, K = q.shape[0], q.shape[2], q.shape[3], k.shape[2]
    res = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
           jnp.asarray(o.numpy().reshape(B, Sq, K, H // K, hd)),
           jnp.asarray(lse.transpose(1, 2).reshape(B, Sq, K, H // K)
                       .numpy()),
           jnp.float32(window), jnp.float32(q_offset), jnp.float32(kv_len))
    want = jattention._flash_bwd_rule(causal, cap, KV_BLOCK, True, res,
                                      jnp.asarray(do))[:3]
    for a, b, n in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-5, err_msg=f"rule d{n}")


# --- naive_attention over key positions --------------------------------------


@pytest.mark.parametrize("causal,window,cap,q_offset,kv_len", [
    (True, 8, 0.0, 10, None),          # a ring of 8 after 11 writes
    (True, 6, 30.0, 13, None),
    (False, 0, 0.0, 4, 9),             # non-causal, kv_len over positions
])
def test_naive_attention_k_positions_match_jax(causal, window, cap, q_offset,
                                               kv_len):
    """Keys at explicit positions (a ring's slots, -1 empty) with a query
    offset: the hybrid family's scalar ring decode attention."""
    rng = np.random.default_rng(3)
    B, W, K, G, hd = 2, 12, 2, 2, 16
    q = rng.standard_normal((B, 1, K * G, hd)).astype(np.float32)
    k = rng.standard_normal((B, W, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, W, K, hd)).astype(np.float32)
    kpos = np.array([8, 9, 10, 3, 4, 5, 6, 7, -1, -1, 2, -1], np.int32)
    kw = _jkw(causal, window, cap, q_offset, kv_len)
    want = jattention.naive_attention(*map(jnp.asarray, (q, k, v)),
                                      k_positions=jnp.asarray(kpos), **kw)
    got = naive_attention(*map(torch.from_numpy, (q, k, v)),
                          k_positions=torch.from_numpy(kpos), **kw)
    _close(got, want, 2e-5)
    # a 0-d tensor offset gives the same bits as the int
    kw["q_offset"] = torch.tensor(q_offset)
    again = naive_attention(*map(torch.from_numpy, (q, k, v)),
                            k_positions=torch.from_numpy(kpos), **kw)
    assert torch.equal(again, got)


# --- attention_block: non-causal and cross-attention -------------------------


@pytest.fixture(scope="module")
def llama():
    return _pair("llama3-8b")


def _pair(arch, T=64, **over):
    jcfg = jreduced(jget_config(arch), dtype="float32", **over)
    jmodel = jbuild_model(jcfg, max_seq=T)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    cfg = reduced(get_config(arch), dtype="float32", **over)
    model = build_model(cfg, max_seq=T, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("impl,jimpl", [("plain", "naive"),
                                        ("kernel", "chunked"),
                                        ("kernel_bf16", "chunked_bf16")])
@pytest.mark.parametrize("what", ["noncausal", "kv_source"])
def test_attention_block_noncausal_and_kv_source_match_jax(llama, impl,
                                                           jimpl, what):
    """One layer's ``attention_block``: ``causal=False`` over the sequence,
    and ``kv_source`` (k, v projected from another sequence of another
    length, no RoPE on q or k, never causal), against JAX's."""
    jmodel, jparams, model, params = llama
    cfg = model.cfg
    rng = np.random.default_rng(4)
    B, S, D = 2, 10, cfg.d_model
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    src = rng.standard_normal((B, 7, D)).astype(np.float32)
    jp = {n[len("blocks/attn/"):]: w[0] for n, w in jparams.items()
          if n.startswith("blocks/attn/")}
    tp = {n[len("blocks/attn/"):]: w[0] for n, w in params.items()
          if n.startswith("blocks/attn/")}
    jkw, tkw = {}, {}
    if what == "noncausal":
        jkw["causal"] = tkw["causal"] = False
    else:
        jkw["kv_source"] = jnp.asarray(src)
        tkw["kv_source"] = torch.from_numpy(src)
    want, _ = jattention.attention_block(
        jmodel.cfg, jp, jnp.asarray(x), positions=jnp.arange(S), impl=jimpl,
        **jkw)
    pos = torch.arange(S, dtype=torch.int32)[None]
    got, _ = attention_block(
        cfg, tp, torch.from_numpy(x), impl=impl,
        rope_cs=rope_tables(pos, cfg.head_dim, cfg.rope_theta), **tkw)
    _close(got, want, 2e-2 if impl == "kernel_bf16" else 2e-5)
    causal, _ = attention_block(
        cfg, tp, torch.from_numpy(x), impl=impl,
        rope_cs=rope_tables(pos, cfg.head_dim, cfg.rope_theta))
    assert not torch.allclose(causal, got)


def test_attention_block_refusals(llama):
    _, _, model, params = llama
    cfg = model.cfg
    tp = {n[len("blocks/attn/"):]: w[0] for n, w in params.items()
          if n.startswith("blocks/attn/")}
    cache = {n: c[0] for n, c in model.init_cache(2, 16).items()}
    x = torch.zeros(2, 2, cfg.d_model)
    with pytest.raises(ValueError, match="one token"):
        attention_block(cfg, tp, x, rope_cs=None, cache=cache, cache_pos=3)
    with pytest.raises(ValueError, match="not in"):
        attention_block(cfg, tp, x[:, :1], rope_cs=None, cache=cache,
                        cache_pos=3, impl="pallas")
    with pytest.raises(ValueError, match="not in"):
        attention_block(cfg, tp, x, rope_cs=None, impl="chunked")
    with pytest.raises(ValueError, match="vector"):
        attention_block(cfg, tp, x[:, :1], rope_cs=None, cache=cache,
                        cache_pos=3, page_table=torch.zeros(2, 2,
                                                            dtype=torch.int32))


# --- scalar-position decode --------------------------------------------------

SCALAR_ARCHS = [("llama3-8b", {}), ("gemma2-27b", {"local_window": 8}),
                ("mamba2-1.3b", {}), ("recurrentgemma-2b", {"local_window": 8}),
                ("qwen2-7b", {}),
                # capacity factor E / top_k: the forward over T tokens drops
                # none, as the one-token decode never does
                ("granite-moe-3b-a800m", {"moe_capacity_factor": 4.0}),
                ("internvl2-26b", {})]


@pytest.mark.parametrize("arch,over", SCALAR_ARCHS,
                         ids=[a for a, _ in SCALAR_ARCHS])
def test_scalar_decode_matches_jax_and_forward(arch, over):
    """Token-by-token ``decode_step`` at a scalar position (an int, then a
    0-d tensor) through the flash route, against JAX's scalar
    ``decode_step`` (its default route) and against the port's own train
    forward, as JAX's ``test_decode_matches_forward``; the plain route
    gives the same logits; the final caches equal JAX's."""
    T = 12
    jmodel, jparams, model, params = _pair(arch, T, **over)
    tokens = np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (2, T)).astype(np.int32)
    full, _, _ = model.forward(params, {"tokens": torch.from_numpy(tokens)},
                               mode="train", attn_impl="plain")
    jstep = jax.jit(lambda p, c, b, pos: jmodel.decode_step(p, c, b, pos))
    jcache = jmodel.init_cache(2, T)
    caches = {impl: model.init_cache(2, T) for impl in ("kernel", "plain")}
    for t in range(T):
        jl, jcache = jstep(jparams, jcache,
                           {"tokens": jnp.asarray(tokens[:, t:t + 1])}, t)
        pos = t if t % 2 else torch.tensor(t)
        for impl in ("kernel", "plain"):
            tl, caches[impl] = model.decode_step(
                params, caches[impl],
                {"tokens": torch.from_numpy(tokens[:, t:t + 1])}, pos,
                attn_impl=impl)
            _close(tl[:, 0], jl[:, 0], 2e-3, f"{impl} step {t} vs JAX")
            _close(tl[:, 0], full[:, t], 2e-3, f"{impl} step {t} vs forward")
    for n in jcache:
        _close(caches["kernel"][n], jcache[n], 1e-4, n)


# --- prefill through the flash route -----------------------------------------

PREFILL_ARCHS = [("llama3-8b", {}), ("gemma2-27b", {"local_window": 8}),
                 ("qwen2-7b", {}), ("granite-moe-3b-a800m", {}),
                 ("internvl2-26b", {}),
                 ("recurrentgemma-2b", {"local_window": 8})]


@pytest.mark.parametrize("arch,over", PREFILL_ARCHS,
                         ids=[a for a, _ in PREFILL_ARCHS])
def test_prefill_kernel_route_matches_jax_default(arch, over, monkeypatch):
    """``Model.prefill`` (default ``attn_impl="kernel"``: every attention
    layer through ``chunked_attention``) against JAX's ``Model.prefill``
    default (``"chunked"``): logits and every cache bank."""
    from repro_torch.models import attention
    jmodel, jparams, model, params = _pair(arch, 32, **over)
    toks = np.random.default_rng(6).integers(0, 512, (2, 20)).astype(
        np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if arch == "internvl2-26b":
        ve = np.random.default_rng(7).standard_normal(
            (2, model.cfg.vision_tokens, model.cfg.d_model)).astype(
                np.float32)
        jb["vision_embeds"], tb["vision_embeds"] = (jnp.asarray(ve),
                                                    torch.from_numpy(ve))
    calls = []
    real = attention.chunked_attention
    monkeypatch.setattr(attention, "chunked_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jl, jc = jmodel.prefill(jparams, jb)
    tl, tc = model.prefill(params, tb)
    n_attn = sum(1 for n in params if n.endswith("attn/wq"))
    layers = (params["blocks/attn/wq"].shape[0]
              if "blocks/attn/wq" in params else n_attn)
    assert len(calls) == layers
    _close(tl, jl, 1e-4, "logits")
    assert set(tc) == set(jc)
    for n in jc:
        _close(tc[n], jc[n], 1e-4, n)
    with pytest.raises(ValueError, match="attn_impl"):
        model.prefill(params, tb, attn_impl="chunked")


# --- small parity gaps --------------------------------------------------------


@pytest.mark.parametrize("capacity_mb,scale,ways", [(0.25, 1, 16),
                                                    (3, 64, 4)])
def test_simulate_capacity_matches_jax(capacity_mb, scale, ways):
    trace = cachesim.synthetic_trace(4000, 12_000, seed=3)
    want = jcachesim.simulate_capacity(trace, capacity_mb, scale=scale,
                                       ways=ways, use_kernel=False)
    for use_kernel in (True, False):
        got = cachesim.simulate_capacity(trace, capacity_mb, scale=scale,
                                         ways=ways, use_kernel=use_kernel,
                                         device="cpu")
        assert got == tuple(want)
    lines = cachesim.capacity_lines(capacity_mb, scale=scale)
    assert cachesim.simulate_capacity_lines(
        trace, lines, ways=ways, device="cpu") == tuple(want)
    assert cachesim.simulate_capacity_lines is cachesim.simulate_reference


def test_engine_reference_alias():
    from repro_torch import serve
    from repro_torch.serve import engine
    assert serve.engine_reference is serve.EngineReference
    assert engine.engine_reference is engine.EngineReference
    assert "engine_reference" in serve.__all__
