"""The port's training stack (``repro_torch``'s flash attention, train-mode
model, optimizer, data, trainer and checkpoints; the launcher's runs are in
``tests/test_torch_train_launcher.py``) against the JAX
package's, on the CPU, on inputs made with numpy from a seed and weights
carried over by ``params_from_numpy`` / ``train_state_from_numpy``.

Tolerances: the plain flash attention against the Pallas kernel (interpret
mode) and ``ref.flash_attention_ref`` within the JAX kernel test's bounds
(f32 2e-5, bf16 2e-2); ``FlashAttention`` forward within 2e-5 of
``chunked_attention`` and its gradients within rtol 3e-4 / atol 3e-5 of
``jax.grad`` (``tests/test_models.py``'s bounds), lse within 1e-5; the
train-mode loss within rel 1e-5 and its gradients within 3e-4 / 3e-5; the
schedule and three AdamW updates within rel 1e-6 (f32 arithmetic in
another order); the token stream bit for bit; the port's trajectories
within rel 2e-5 of the JAX per-step oracle (f32 sums in another order,
compounded over 4 steps; with EF-int8 compression at most 2 elements
may sit one int8 quantum apart, bounded by what one quantum does to
Adam), and the port's window bit for bit equal to its own per-step loop;
compressed train states and checkpoints equal leaf for leaf both ways.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import Pipeline as JPipeline  # noqa: E402
from repro.data import batch_for_step as jbatch_for_step  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.optim import warmup_cosine as jwarmup_cosine  # noqa: E402
from repro.train.checkpoint import \
    CheckpointManager as JCheckpointManager  # noqa: E402
from repro.train.trainer import effective_optimizer as jeffective  # noqa: E402,E501
from repro.train.trainer import init_state as jinit_state  # noqa: E402
from repro.train.trainer import make_train_step as jmake_train_step  # noqa: E402,E501
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import (DataConfig, Pipeline, batch_for_step,  # noqa: E402,E501
                              device_batch_at)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import chunked_attention  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        train_state_from_numpy)
from repro_torch.optim import AdamW, constant, warmup_cosine  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.elastic import StragglerMonitor  # noqa: E402
from repro_torch.train.trainer import (clone_state,  # noqa: E402
                                       effective_optimizer, init_state,
                                       make_train_step, make_train_window)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SEQ, BATCH, K = 8, 4, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(x: np.ndarray, dtype: str):
    """The same values (rounded to ``dtype`` identically) in both."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(x).to(getattr(torch, dtype))
    return j, t


def _assert_close(t, j, tol, what=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol,
                               err_msg=what)


# --- the kernel's plain version ----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,Kh,Sq,Skv,hd,causal,window,cap,bq,bk",
    [
        (1, 4, 2, 128, 128, 64, True, 0, 0.0, 64, 64),
        (2, 4, 4, 64, 64, 32, True, 0, 0.0, 32, 32),
        (1, 6, 2, 128, 128, 64, True, 48, 0.0, 64, 64),     # local window
        (1, 4, 1, 64, 64, 128, True, 0, 50.0, 32, 32),      # softcap + MQA
        (1, 2, 2, 64, 128, 64, False, 0, 0.0, 64, 64),      # cross attn
        (2, 4, 2, 64, 64, 16, True, 0, 0.0, 32, 32),        # reduced() hd
        (1, 4, 2, 96, 96, 16, True, 24, 30.0, 32, 32),
        (1, 4, 4, 64, 64, 96, True, 0, 0.0, 32, 32),        # phi3's hd
        (1, 6, 2, 64, 96, 96, False, 0, 50.0, 32, 32),
    ])
def test_flash_plain_matches_pallas_and_ref(dtype, B, H, Kh, Sq, Skv, hd,
                                            causal, window, cap, bq, bk):
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, H, Sq, hd), (B, Kh, Skv, hd), (B, Kh, Skv, hd)))
    pallas = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                  logit_cap=cap, bq=bq, bk=bk)
    want = jref.flash_attention_ref(qj, kj, vj, causal=causal,
                                    window=window, logit_cap=cap)
    got, lse = ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                   logit_cap=cap, return_lse=True)
    assert got.dtype == qt.dtype and lse.shape == (B, H, Sq)
    _assert_close(got, pallas, TOL[dtype], "vs Pallas (interpret)")
    _assert_close(got, want, TOL[dtype], "vs flash_attention_ref")
    assert ops.launches["flash_attention"] == 0   # CPU: the plain version


# --- FlashAttention (forward kernel, blockwise backward) ---------------------


@pytest.mark.parametrize("causal,window,cap,gqa,S,kv_block", [
    (True, 0, 0.0, 2, 64, 16), (True, 32, 50.0, 1, 64, 16),
    (False, 0, 0.0, 4, 64, 16),
    (True, 24, 30.0, 2, 40, 16),      # ragged last kv block
])
def test_flash_attention_grads_match_jax(causal, window, cap, gqa, S,
                                         kv_block):
    B, Kh, hd = 2, 2, 16
    H = Kh * gqa
    rng = np.random.default_rng(1)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, S, H, hd), (B, S, Kh, hd), (B, S, Kh, hd))]

    def jf(q, k, v):
        return (jattention.chunked_attention(
            q, k, v, causal=causal, window=window, logit_cap=cap,
            kv_block=kv_block) ** 2).sum()

    jl, jg = jax.value_and_grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, xs))
    jo = jattention.chunked_attention(*map(jnp.asarray, xs), causal=causal,
                                      window=window, logit_cap=cap,
                                      kv_block=kv_block)
    _, jlse = jattention._flash_fwd_scan(
        *map(jnp.asarray, xs), jnp.float32(window), jnp.float32(0),
        jnp.float32(S), causal, cap, kv_block)

    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    to = chunked_attention(*ts, causal=causal, window=window, logit_cap=cap,
                           kv_block=kv_block)
    tl = (to ** 2).sum()
    tg = torch.autograd.grad(tl, ts)
    _assert_close(to, jo, 2e-5, "forward")
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-5)
    for a, b, n in zip(tg, jg, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-4,
                                   atol=3e-5, err_msg=f"d{n}")
    _, lse = ops.flash_attention(*(t.detach().transpose(1, 2) for t in ts),
                                 causal=causal, window=window, logit_cap=cap,
                                 return_lse=True)
    np.testing.assert_allclose(
        lse.transpose(1, 2).reshape(jlse.shape).numpy(), np.asarray(jlse),
        rtol=1e-5, atol=1e-5)


def test_flash_check_args_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 2, 40, 32)
    k = torch.zeros(1, 2, 8, 32)
    from repro_torch.kernels import flash_attention as fa
    with pytest.raises(ValueError, match="no key"):
        fa.check_args(q, k, k, True, 16, 0.0)
    with pytest.raises(ValueError, match="head_dim"):   # no config's
        fa.check_args(torch.zeros(1, 2, 40, 48), torch.zeros(1, 2, 8, 48),
                      torch.zeros(1, 2, 8, 48), True, 0, 0.0)
    fa.check_args(q[..., :16], k[..., :16], k[..., :16], True, 0, 0.0)
    fa.check_args(q.transpose(1, 2).contiguous().transpose(1, 2),
                  k, k, True, 0, 0.0)          # strided model layout


# --- train-mode model --------------------------------------------------------


def _models(arch, remat="none", **over):
    jcfg = jreduced(jget_config(arch), dtype="float32", **over)
    jmodel = jbuild_model(jcfg, max_seq=64)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch), dtype="float32", remat=remat, **over)
    model = build_model(cfg, max_seq=64, device="cpu")
    params = params_from_numpy(cfg, _np_tree(jparams), device="cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("arch,impl,remat", [
    ("llama3-8b", "kernel", "none"), ("llama3-8b", "plain", "none"),
    ("llama3-8b", "kernel", "full"),
    ("gemma2-27b", "kernel", "none"), ("gemma2-27b", "plain", "full"),
])
def test_train_loss_and_grads_match_jax(arch, impl, remat):
    jmodel, jparams, model, params = _models(arch, remat)
    toks = np.random.default_rng(2).integers(0, 512, (2, 41)).astype(
        np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    jimpl = {"kernel": "chunked", "plain": "naive"}[impl]
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, attn_impl=jimpl))(jparams)
    leaves = {n: p.requires_grad_() for n, p in params.items()}
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in jbatch.items()}
    tl = model.loss(leaves, batch, attn_impl=impl)
    tg = dict(zip(leaves, torch.autograd.grad(tl, list(leaves.values()))))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for n, g in tg.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[n]), rtol=3e-4,
                                   atol=3e-5, err_msg=n)


# --- optimizer and schedule --------------------------------------------------


def test_schedules_match_jax():
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    for jf, tf in ((jwarmup_cosine(1e-3, 10, 100), warmup_cosine(1e-3, 10,
                                                                 100)),
                   (jwarmup_cosine(3e-4, 0, 7, 0.2),
                    warmup_cosine(3e-4, 0, 7, 0.2)),
                   (jconstant(2e-3), constant(2e-3))):
        for s in steps:
            got = tf(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.ndim == 0
            np.testing.assert_allclose(float(got), float(jf(s)), rtol=1e-6)


@pytest.mark.parametrize("master", [True, False])
def test_adamw_three_updates_match_jax(master):
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b/c": (3,), "d": (2, 4, 6)}
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    kw = dict(weight_decay=0.1, clip_norm=1.0, master_weights=master)
    jopt = JAdamW(lr=jwarmup_cosine(1e-2, 2, 10), **kw)
    topt = AdamW(lr=warmup_cosine(1e-2, 2, 10), **kw)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    js = jopt.init(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    ts = topt.init(tp)
    for i, gscale in enumerate((5.0, 0.01, 1.0)):   # clipped, then not
        g = {n: (gscale * rng.standard_normal(s)).astype(np.float32)
             for n, s in shapes.items()}
        jp, js, jm = jopt.update({n: jnp.asarray(a) for n, a in g.items()},
                                 js, jp)
        tm = topt.update({n: torch.from_numpy(a) for n, a in g.items()}, ts,
                         tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        trees = [("params", tp, jp), ("m", ts["m"], js["m"]),
                 ("v", ts["v"], js["v"])]
        if master:
            trees.append(("master", ts["master"], js["master"]))
        for what, t, j in trees:
            for n in shapes:
                np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n]),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"{what} {n} step {i}")


# --- data --------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,hosts,hid", [
    (0, 0, 1, 0), (3, 17, 1, 0), (1, 12345, 2, 1), (2 ** 33 + 5, 2 ** 31 - 1,
                                                    1, 0)])
def test_batches_bitwise_match_jax_pipeline(seed, step, hosts, hid):
    kw = dict(seed=seed, num_hosts=hosts, host_id=hid)
    want = jbatch_for_step(JDataConfig(512, 16, 4 * hosts, **kw), step)
    cfg = DataConfig(512, 16, 4 * hosts, **kw)
    host = batch_for_step(cfg, step)
    dev = device_batch_at(cfg, torch.tensor(step, dtype=torch.int64))
    dev_int = device_batch_at(cfg, step)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(host[k], want[k])
        np.testing.assert_array_equal(dev[k].numpy(), want[k])
        np.testing.assert_array_equal(dev_int[k].numpy(), want[k])
        assert dev[k].dtype == torch.int32


def test_device_batch_tokens_in_vocab_and_shifted():
    b = device_batch_at(DataConfig(128, 16, 4), torch.tensor(9))
    assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 128
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_resume_matches_random_access():
    cfg = DataConfig(256, 16, 4, seed=11)
    p = Pipeline(cfg, start_step=7)
    got = [next(p) for _ in range(3)]
    p.close()
    assert not p._thread.is_alive()
    for i, b in enumerate(got):
        want = batch_for_step(cfg, 7 + i)
        np.testing.assert_array_equal(b["tokens"], want["tokens"])
        np.testing.assert_array_equal(b["labels"], want["labels"])
    assert p.state["step"] == 10


# --- trainer: per-step and window against the JAX oracle ---------------------


@pytest.fixture(scope="module")
def setup():
    over = dict(dtype="float32", num_layers=1, d_model=16, d_ff=32,
                num_heads=1, num_kv_heads=1, head_dim=16, vocab_size=128)
    jcfg = jreduced(jget_config("llama3-8b"), **over)
    jmodel = jbuild_model(jcfg, max_seq=SEQ)
    jopt = JAdamW(lr=jconstant(1e-3), weight_decay=0.0)
    cfg = reduced(get_config("llama3-8b"), **over)
    model = build_model(cfg, max_seq=SEQ, device="cpu")
    opt = AdamW(lr=constant(1e-3), weight_decay=0.0)
    jstate0 = _np_tree(jinit_state(jmodel, jopt, jax.random.PRNGKey(0)))
    dcfg = DataConfig(cfg.vocab_size, SEQ, BATCH)
    return dict(jmodel=jmodel, jopt=jopt, jstate0=jstate0, cfg=cfg,
                model=model, opt=opt, dcfg=dcfg)


def _jstate0(s, kw):
    """The JAX initial state (numpy) for step options ``kw``: with
    compression, the wrapped optimizer's state around the same params."""
    if not kw.get("compress_grads"):
        return s["jstate0"]
    opt = jeffective(s["jopt"], True, kw.get("compress_shards", 1))
    params = jax.tree.map(jnp.asarray, s["jstate0"]["params"])
    return dict(s["jstate0"], opt=_np_tree(opt.init(params)))


def _jax_oracle(s, steps, **kw):
    state = jax.tree.map(jnp.asarray, _jstate0(s, kw))
    fn = jax.jit(jmake_train_step(s["jmodel"], s["jopt"], **kw))
    data = JPipeline(JDataConfig(s["cfg"].vocab_size, SEQ, BATCH))
    out = []
    for _ in range(steps):
        state, m = fn(state, jax.tree.map(jnp.asarray, next(data)))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    data.close()
    return out, state


def _port_state(s, kw=None):
    return train_state_from_numpy(s["cfg"], _jstate0(s, kw or {}),
                                  device="cpu")


def _port_per_step(s, steps, **kw):
    state = _port_state(s, kw)
    fn = make_train_step(s["model"], s["opt"], **kw)
    data = Pipeline(s["dcfg"])
    out = []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        state, m = fn(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    data.close()
    return out, state


def _port_window(s, steps, state=None, **kw):
    state = _port_state(s, kw) if state is None else state
    win = make_train_window(s["model"], s["opt"], steps_per_sync=steps,
                            data_cfg=s["dcfg"], **kw)
    state, m = win(state)
    return list(zip(m["loss"].tolist(), m["grad_norm"].tolist())), state


COMPRESSED = {"compress_grads": True, "compress_shards": 2}


def _adam_step_bound(b1: float, b2: float, t: int) -> float:
    """The largest |m_hat / sqrt(v_hat)| Adam can take at step t, over any
    gradients (Cauchy-Schwarz on m against v): each element moves by at
    most lr x this a step."""
    s = sum((b1 * b1 / b2) ** k for k in range(t))
    return ((1 - b1) * s ** 0.5 / (1 - b2) ** 0.5
            * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t))


@pytest.mark.parametrize("kw", [{}, {"microbatches": 2}, COMPRESSED,
                                {"microbatches": 2, **COMPRESSED}],
                         ids=["plain", "microbatched", "compressed",
                              "micro+compressed"])
def test_trajectories_match_jax_oracle_and_window_is_bitwise(setup, kw):
    """Params within rtol 2e-5 of the JAX oracle's.  With compression an
    element whose corrected gradient lies within the two packages' f32
    roundoff of an int8 rounding boundary (x / scale = k + 0.5) is
    quantized one quantum apart (one in the compressed case: x / scale
    8.49997 in JAX, 8.50004 here, at step 4).  One quantum in one
    element's gradient changes only that element's Adam steps, each at
    most lr x ``_adam_step_bound``, so such an element may differ by
    twice that a step, and at most 2 elements may."""
    jtraj, jstate = _jax_oracle(setup, K, **kw)
    per_step, s1 = _port_per_step(setup, K, **kw)
    fused, s2 = _port_window(setup, K, **kw)
    np.testing.assert_allclose(np.asarray(per_step), np.asarray(jtraj),
                               rtol=2e-5, atol=1e-7)
    assert fused == per_step       # bitwise: same tokens, same step
    assert _equal_states(s1, s2)
    opt = setup["opt"]
    flip = 2 * float(opt.lr(torch.tensor(K))) * K * _adam_step_bound(
        opt.b1, opt.b2, K)
    flipped = 0
    for n, p in s1["params"].items():
        got, want = p.numpy(), np.asarray(jstate["params"][n])
        off = np.abs(got - want) > 1e-6 + 2e-5 * np.abs(want)
        if kw.get("compress_grads"):
            flipped += int(off.sum())
            np.testing.assert_array_less(np.abs(got - want)[off], flip,
                                         err_msg=n)
        else:
            assert not off.any(), (n, np.abs(got - want).max())
    print(f"elements one quantum apart: {flipped}")
    assert flipped <= 2, flipped
    assert int(s1["step"]) == int(s2["step"]) == K


def test_window_step_counter_is_data_position(setup):
    state = _port_state(setup)
    win = make_train_window(setup["model"], setup["opt"], steps_per_sync=2,
                            data_cfg=setup["dcfg"])
    state, m1 = win(state)
    state, m2 = win(state)
    fused, _ = _port_window(setup, 4)
    assert m1["loss"].tolist() + m2["loss"].tolist() == [l for l, _ in fused]
    assert win.windows_run == 2


def test_window_checkpoint_restore_resumes_exactly(setup, tmp_path):
    win = make_train_window(setup["model"], setup["opt"], steps_per_sync=2,
                            data_cfg=setup["dcfg"])
    mgr = CheckpointManager(str(tmp_path))
    state, _ = win(_port_state(setup))
    mgr.save(2, state, blocking=True)
    state, m_cont = win(state)
    like = init_state(setup["model"], setup["opt"],
                      torch.Generator().manual_seed(1))
    restored = mgr.restore(like)
    assert int(restored["step"]) == 2
    restored, m_res = win(restored)
    for k in ("loss", "grad_norm"):
        assert torch.equal(m_cont[k], m_res[k])
    for n, p in state["params"].items():
        assert torch.equal(p, restored["params"][n]), n


def test_window_and_step_validate_args(setup):
    model, opt, dcfg = setup["model"], setup["opt"], setup["dcfg"]
    with pytest.raises(ValueError):
        make_train_window(model, opt, steps_per_sync=0, data_cfg=dcfg)
    with pytest.raises(ValueError):      # 4 rows not divisible by 3 chunks
        make_train_window(model, opt, steps_per_sync=1, microbatches=3,
                          data_cfg=dcfg)
    with pytest.raises(ValueError, match="requires compress_grads"):
        make_train_step(model, opt, compress_shards=2)
    with pytest.raises(ValueError, match="requires compress_grads"):
        make_train_window(model, opt, steps_per_sync=1, data_cfg=dcfg,
                          compress_shards=2)
    with pytest.raises(ValueError, match="compress_shards must be"):
        make_train_step(model, opt, compress_grads=True, compress_shards=0)
    with pytest.raises(ValueError, match="microbatches x compress_shards"):
        make_train_window(model, opt, steps_per_sync=1, microbatches=2,
                          compress_grads=True, compress_shards=3,
                          data_cfg=dcfg)   # 4 rows, 6 chunks


def test_clone_state_is_deep(setup):
    state = _port_state(setup)
    copy = clone_state(state)
    state["opt"]["m"]["emb/tok"] += 1
    state["step"] += 1
    assert int(copy["step"]) == 0
    assert not torch.equal(copy["opt"]["m"]["emb/tok"],
                           state["opt"]["m"]["emb/tok"])


# --- checkpoints -------------------------------------------------------------


def test_port_restores_jax_checkpoint_and_jax_restores_ports(tmp_path):
    cfg = reduced(get_config("llama3-8b"))            # bfloat16 params
    jmodel = jbuild_model(jreduced(jget_config("llama3-8b")), max_seq=16)
    jopt = JAdamW(lr=jconstant(1e-3))
    jstate = jinit_state(jmodel, jopt, jax.random.PRNGKey(0))
    jstate["step"] = jnp.int32(5)
    JCheckpointManager(str(tmp_path / "jax")).save(5, jstate, blocking=True)
    model = build_model(cfg, max_seq=16, device="cpu")
    opt = AdamW(lr=constant(1e-3))
    like = init_state(model, opt, torch.Generator().manual_seed(1))
    got = CheckpointManager(str(tmp_path / "jax")).restore(like)
    want = train_state_from_numpy(cfg, _np_tree(jstate), device="cpu")
    assert got["params"]["emb/tok"].dtype == torch.bfloat16
    for (k, a), (k2, b) in zip(
            sorted(_flat(got).items()), sorted(_flat(want).items())):
        assert k == k2 and a.dtype == b.dtype and torch.equal(a, b), k
    # and back: the port's checkpoint (bf16 as uint16 bits) into JAX
    CheckpointManager(str(tmp_path / "port")).save(5, got, blocking=True)
    back = JCheckpointManager(str(tmp_path / "port")).restore(
        jinit_state(jmodel, jopt, jax.random.PRNGKey(1)))
    assert back["params"]["emb/tok"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["params"]["emb/tok"], np.float32),
        np.asarray(jstate["params"]["emb/tok"], np.float32))
    assert int(back["step"]) == 5


@pytest.mark.parametrize("shards", [1, 2])
def test_compressed_checkpoint_round_trips_with_jax(setup, tmp_path, shards):
    """A compressed train state after 2 JAX steps (error buffers nonzero,
    with their shard axis at 2 shards), saved by the JAX manager, restores
    here equal to ``train_state_from_numpy`` of it, leaf for leaf; the
    port's checkpoint of it restores in JAX equal to the JAX state."""
    kw = {"compress_grads": True, "compress_shards": shards}
    _, jstate = _jax_oracle(setup, 2, **kw)
    JCheckpointManager(str(tmp_path / "jax")).save(2, jstate, blocking=True)
    opt = effective_optimizer(setup["opt"], True, shards)
    like = init_state(setup["model"], opt, torch.Generator().manual_seed(1))
    got = CheckpointManager(str(tmp_path / "jax")).restore(like)
    want = train_state_from_numpy(setup["cfg"], _np_tree(jstate),
                                  device="cpu")
    assert _equal_states(got, want)
    lead = (shards,) if shards > 1 else ()
    for n, e in got["opt"]["err"].items():
        assert tuple(e.shape) == lead + tuple(got["params"][n].shape), n
    assert any(bool(e.abs().sum() > 0) for e in got["opt"]["err"].values())
    CheckpointManager(str(tmp_path / "port")).save(2, got, blocking=True)
    back = JCheckpointManager(str(tmp_path / "port")).restore(
        jax.tree.map(jnp.asarray, _jstate0(setup, kw)))
    for (k, a), (k2, b) in zip(sorted(_flat(_np_tree(back)).items()),
                               sorted(_flat(_np_tree(jstate)).items())):
        assert k == k2 and a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_train_state_from_numpy_checks_error_buffers(setup):
    jstate = _jstate0(setup, COMPRESSED)
    err = jstate["opt"]["err"]
    name = sorted(err)[0]
    bad = dict(jstate, opt=dict(jstate["opt"], err=dict(
        err, **{name: np.zeros((3,) + err[name].shape[1:], np.float32)})))
    with pytest.raises(ValueError, match="leading shapes"):
        train_state_from_numpy(setup["cfg"], bad, device="cpu")
    bad = dict(jstate, opt=dict(jstate["opt"], err=dict(
        err, **{name: np.zeros((5, 5), np.float32)})))
    with pytest.raises(ValueError, match="neither"):
        train_state_from_numpy(setup["cfg"], bad, device="cpu")


def _flat(state, prefix=""):
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update(_flat(v, f"{prefix}{k}::"))
        return out
    return {prefix: state}


def _equal_states(a, b) -> bool:
    fa, fb = _flat(a), _flat(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def test_checkpoint_resave_same_step_updates(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, {"w": torch.zeros(3)}, blocking=True)
    mgr.save(5, {"w": torch.ones(3)}, blocking=True)
    assert mgr.all_steps() == [5]
    assert torch.equal(mgr.restore({"w": torch.zeros(3)})["w"],
                       torch.ones(3))


@pytest.mark.parametrize("surfaces_at", ["wait", "next save"])
def test_checkpoint_writer_error_propagates(tmp_path, monkeypatch,
                                            surfaces_at):
    mgr = CheckpointManager(str(tmp_path))

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr("repro_torch.train.checkpoint.np.save", boom)
    mgr.save(1, {"w": torch.zeros(2)})
    mgr._thread.join(timeout=30)
    assert not mgr._thread.is_alive()
    monkeypatch.undo()
    with pytest.raises(OSError, match="disk full"):
        if surfaces_at == "wait":
            mgr.wait()
        else:
            mgr.save(2, {"w": torch.zeros(2)})
    # the error is consumed: the manager keeps working afterwards
    mgr.save(3, {"w": torch.zeros(2)}, blocking=True)
    assert mgr.all_steps() == [3]


def test_checkpoint_crash_mid_swap_recovers(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, {"w": torch.full((3,), 7.0)}, blocking=True)
    os.rename(tmp_path / "step_7", tmp_path / "step_7.old")
    assert CheckpointManager(str(tmp_path)).all_steps() == [7]
    restored = CheckpointManager(str(tmp_path)).restore(
        {"w": torch.zeros(3)})
    assert torch.equal(restored["w"], torch.full((3,), 7.0))
    mgr.save(7, {"w": torch.zeros(3)}, blocking=True)
    os.makedirs(tmp_path / "step_7.old", exist_ok=True)
    CheckpointManager(str(tmp_path))
    assert not (tmp_path / "step_7.old").exists()


def test_checkpoint_keep_zero_rejected(tmp_path):
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep=0)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    for s in (1, 2, 3):
        mgr.save(s, {"w": torch.zeros(2)}, blocking=True)
    assert mgr.all_steps() == [3]


def test_checkpoint_bf16_roundtrip_and_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(8.0, dtype=torch.bfloat16)
    mgr.save(1, {"w": w, "n": torch.tensor(3, dtype=torch.int32)},
             blocking=True)
    assert mgr.manifest()["leaves"]["w"]["dtype"] == "bfloat16"
    r = mgr.restore({"w": torch.zeros(8, dtype=torch.bfloat16),
                     "n": torch.zeros((), dtype=torch.int32)})
    assert r["w"].dtype == torch.bfloat16 and torch.equal(r["w"], w)
    assert r["n"].shape == () and int(r["n"]) == 3
    with pytest.raises(ValueError, match="checkpoint"):
        mgr.restore({"w": torch.zeros(8), "n": torch.zeros((), dtype=torch.int32)})
    with pytest.raises(KeyError):
        mgr.restore({"x": torch.zeros(8)})


# --- straggler strike semantics ----------------------------------------------


def _strikes(mon, slow_host, slow, steps):
    reports = []
    for _ in range(steps):
        for h in range(4):
            mon.record(h, slow if h == slow_host else 1.0)
        reports.append(mon.stragglers())
    return reports


def test_straggler_reported_once_per_episode():
    mon = StragglerMonitor(num_hosts=4, threshold=1.5, patience=3)
    assert _strikes(mon, 2, 3.0, 8) == [[], [], [2], [], [], [2], [], []]


def test_straggler_double_call_does_not_rereport():
    mon = StragglerMonitor(num_hosts=4, threshold=1.5, patience=3)
    assert _strikes(mon, 1, 4.0, 3) == [[], [], [1]]
    assert mon.stragglers() == []


def test_straggler_recovery_resets_strikes():
    mon = StragglerMonitor(num_hosts=4, threshold=1.5, patience=3)
    assert _strikes(mon, 2, 3.0, 1) == [[]]
    assert _strikes(mon, 2, 1.0, 4)[-1] == []    # EMA decays; strike zeroed
    assert _strikes(mon, 2, 3.0, 3) == [[], [], [2]]
