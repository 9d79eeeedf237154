"""Training of the port's moe (granite, moonshot) and vlm (internvl2)
families against the JAX package, on the CPU: ``moe_block``'s gradients
with drops, train-mode ``Model.loss`` (cross-entropy plus the router's aux
loss; a vlm batch with its vision embeddings) and its gradients,
granite's K-step trajectories against the JAX per-step oracle, and the
launcher.

Tolerances: gradients within rtol 3e-4 / atol 3e-5 of ``jax.grad``, the
loss within rel 1e-5 (``tests/test_torch_train.py``'s bounds); the
trajectories within rel 2e-5 / atol 1e-7 on loss and grad_norm and params
within rtol 2e-5 / atol 1e-6 of the JAX oracle, the window bit for bit
equal to the per-step loop.  What is zero in JAX is exactly zero here: a
dropped token's gradient into the expert weights, the padded experts'
gradients.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import Pipeline as JPipeline  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import materialize as jmaterialize  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.train.trainer import init_state as jinit_state  # noqa: E402
from repro.train.trainer import make_train_step as jmake_train_step  # noqa: E402,E501
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model, moe  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        train_state_from_numpy)
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.trainer import (make_train_step,  # noqa: E402
                                       make_train_window)

RTOL, ATOL = 3e-4, 3e-5
GRANITE = "granite-moe-3b-a800m"
MOONSHOT = "moonshot-v1-16b-a3b"
INTERNVL = "internvl2-26b"
# moonshot with 16 experts keeps its count a multiple of 16 (the unpadded
# branch); reduced granite pads 8 experts to 16
OVERRIDES = {GRANITE: {}, MOONSHOT: {"num_experts": 16}, INTERNVL: {}}


def _grads_close(got, want, names):
    for g, w, n in zip(got, want, names):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=f"d{n}")


# --- moe_block's backward -----------------------------------------------------

_EXPERTS = ("w_up", "w_gate", "w_down")


def _block(cf):
    kw = dict(dtype="float32", moe_capacity_factor=cf)
    jcfg = jreduced(jget_config(GRANITE), **kw)
    cfg = reduced(get_config(GRANITE), **kw)
    jp = jmaterialize(jmoe.moe_param_defs(jcfg), jax.random.PRNGKey(7),
                      "float32")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 64, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    return jcfg, cfg, jp, x, w


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_block_grads_match_jax_with_drops(cf):
    """Gradients of ``sum(y * w) + aux`` into x, the router and the expert
    weights through the top-k gates, the rank scatters and gathers, the
    expert ``bmm``s and the combine, against ``jax.grad`` of the JAX
    ``moe_block`` on reduced granite (8 experts padded to 16) at capacity
    factors that drop assignments."""
    jcfg, cfg, jp, x, w = _block(cf)
    names = sorted(jp)

    def jloss(p, xj):
        y, aux = jmoe.moe_block(jcfg, p, xj)
        return jnp.sum(y * w) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: torch.from_numpy(np.asarray(v).copy()).requires_grad_()
          for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_block(cfg, tp, xt)
    probs, gates, idx = moe.route(cfg, tp["router"], xt)
    d = moe.dispatch(cfg, idx, moe.capacity(cfg, 64))
    assert int((~d.keep).sum()) > 0                      # drops happen
    tg = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                             [tp[n] for n in names] + [xt])
    _grads_close(tg, [jg[n] for n in names] + [jgx], names + ["x"])
    E = cfg.num_experts
    for n, g in zip(names, tg):
        if n in _EXPERTS:          # the padded experts: exactly zero
            assert not bool(g[E:].any()), n
            assert not np.asarray(jg[n])[E:].any(), n


def test_dropped_tokens_give_the_experts_no_gradient():
    """A loss on the outputs of tokens whose every assignment was dropped
    gives every expert weight an exactly zero gradient, in JAX as here;
    the kept tokens' outputs give the routed experts a nonzero one."""
    jcfg, cfg, jp, x, w = _block(0.5)
    tp = {k: torch.from_numpy(np.asarray(v).copy()).requires_grad_()
          for k, v in jp.items()}
    xt = torch.from_numpy(x)
    _, _, idx = moe.route(cfg, tp["router"], xt)
    d = moe.dispatch(cfg, idx, moe.capacity(cfg, 64))
    K = cfg.top_k
    dropped = (~d.keep).view(3, 64, K).all(-1)           # (B, S)
    assert 0 < int(dropped.sum()) < dropped.numel()
    mask = dropped[..., None].float().numpy()
    for sel, zero in ((mask, True), (1.0 - mask, False)):
        y, _ = moe.moe_block(cfg, tp, xt, with_aux=False)
        tg = torch.autograd.grad((y * torch.from_numpy(w * sel)).sum(),
                                 [tp[n] for n in _EXPERTS])
        jg = jax.grad(lambda p: jnp.sum(
            jmoe.moe_block(jcfg, p, jnp.asarray(x))[0] * (w * sel)))(jp)
        for n, g in zip(_EXPERTS, tg):
            assert (not bool(g.any())) == zero, n
            assert (not np.asarray(jg[n]).any()) == zero, n


# --- the train-mode model -----------------------------------------------------


def _models(arch, remat="none"):
    kw = {**OVERRIDES[arch], "dtype": "float32"}
    jcfg = jreduced(jget_config(arch), **kw)
    jmodel = jbuild_model(jcfg, max_seq=64)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch), remat=remat, **kw)
    model = build_model(cfg, max_seq=64, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch,impl", [
    (GRANITE, "kernel"), (GRANITE, "plain"), (MOONSHOT, "kernel"),
    (INTERNVL, "kernel"), (INTERNVL, "plain"),
])
def test_train_loss_and_grads_match_jax(arch, impl, remat):
    """``Model.loss`` (cross-entropy + the summed aux loss; internvl2 with
    8 seeded vision embeddings a row) and every parameter's gradient
    against JAX's ``Model.loss`` under ``jax.value_and_grad``."""
    jmodel, jparams, model, params = _models(arch, remat)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if arch == INTERNVL:
        batch["vision_embeds"] = rng.standard_normal(
            (2, model.cfg.vision_tokens, model.cfg.d_model)).astype(
                np.float32)
    jimpl = {"kernel": "chunked", "plain": "naive"}[impl]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, attn_impl=jimpl)))(jparams)
    leaves = {n: p.requires_grad_() for n, p in params.items()}
    tl = model.loss(leaves, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, attn_impl=impl)
    tg = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grads_close(tg, [jg[n] for n in leaves], list(leaves))
    with torch.no_grad():
        if model.cfg.is_moe:          # the aux loss is in it
            _, _, aux = model.forward(params, {"tokens": torch.from_numpy(
                batch["tokens"])}, mode="train")
            assert float(aux) > 0
        else:                         # the vision rows reach the embedding
            alt = dict(batch, vision_embeds=batch["vision_embeds"] + 1)
            assert float(model.loss(params, {k: torch.from_numpy(v)
                                             for k, v in alt.items()})) \
                != float(tl.detach())


# --- trajectories against the JAX per-step oracle ----------------------------

SEQ, BATCH, K = 16, 4, 4


@functools.lru_cache(maxsize=None)
def _setup(eps=1e-6):
    over = dict(dtype="float32", num_layers=2, d_model=32, vocab_size=128)
    jcfg = jreduced(jget_config(GRANITE), **over)
    jmodel = jbuild_model(jcfg, max_seq=SEQ)
    # eps 1e-6, not the default 1e-8, unless asked, as in
    # test_torch_train_recurrent.py: an element whose gradient is near eps
    # moves by lr x its gradient's f32 roundoff / eps
    jopt = JAdamW(lr=jconstant(1e-3), weight_decay=0.0, eps=eps)
    cfg = reduced(get_config(GRANITE), **over)
    jstate0 = jax.tree.map(np.asarray,
                           jinit_state(jmodel, jopt, jax.random.PRNGKey(0)))
    return dict(jmodel=jmodel, jopt=jopt, jstate0=jstate0, cfg=cfg,
                model=build_model(cfg, max_seq=SEQ, device="cpu"),
                opt=AdamW(lr=constant(1e-3), weight_decay=0.0, eps=eps),
                dcfg=DataConfig(cfg.vocab_size, SEQ, BATCH))


@pytest.mark.parametrize("kw", [{}, {"microbatches": 2}],
                         ids=["plain", "microbatched"])
def test_granite_trajectories_match_jax_oracle_and_window_is_bitwise(kw):
    s = _setup()
    state = jax.tree.map(jnp.asarray, s["jstate0"])
    fn = jax.jit(jmake_train_step(s["jmodel"], s["jopt"], **kw))
    data = JPipeline(JDataConfig(s["cfg"].vocab_size, SEQ, BATCH))
    jtraj = []
    for _ in range(K):
        state, m = fn(state, jax.tree.map(jnp.asarray, next(data)))
        jtraj.append((float(m["loss"]), float(m["grad_norm"])))
    data.close()

    s1 = train_state_from_numpy(s["cfg"], s["jstate0"], device="cpu")
    step = make_train_step(s["model"], s["opt"], **kw)
    data = Pipeline(s["dcfg"])
    per_step = []
    for _ in range(K):
        s1, m = step(s1, {k: torch.from_numpy(v)
                          for k, v in next(data).items()})
        per_step.append((float(m["loss"]), float(m["grad_norm"])))
    data.close()
    win = make_train_window(s["model"], s["opt"], steps_per_sync=K,
                            data_cfg=s["dcfg"], **kw)
    s2, m = win(train_state_from_numpy(s["cfg"], s["jstate0"], device="cpu"))
    np.testing.assert_allclose(np.asarray(per_step), np.asarray(jtraj),
                               rtol=2e-5, atol=1e-7)
    assert list(zip(m["loss"].tolist(), m["grad_norm"].tolist())) \
        == per_step
    for n, p in s1["params"].items():
        assert torch.equal(p, s2["params"][n]), n
        np.testing.assert_allclose(p.numpy(), np.asarray(state["params"][n]),
                                   rtol=2e-5, atol=1e-6, err_msg=n)


def test_granite_trajectories_at_the_default_eps_match_jax_oracle():
    """AdamW at its default eps 1e-8, as
    ``test_trajectories_at_the_default_eps_match_jax_oracle`` in
    ``tests/test_torch_train_recurrent.py`` holds the recurrent families:
    loss and grad_norm at the dense test's bounds, the params at its
    bounds on every element whose Adam RMS gradient sqrt(v_hat) stayed out
    of (0, eps) at every step, and at most 5% of them not (2.4%: the
    experts see few tokens)."""
    s = _setup(eps=1e-8)
    state = jax.tree.map(jnp.asarray, s["jstate0"])
    fn = jax.jit(jmake_train_step(s["jmodel"], s["jopt"]))
    data = JPipeline(JDataConfig(s["cfg"].vocab_size, SEQ, BATCH))
    jtraj = []
    for _ in range(K):
        state, m = fn(state, jax.tree.map(jnp.asarray, next(data)))
        jtraj.append((float(m["loss"]), float(m["grad_norm"])))
    data.close()

    s1 = train_state_from_numpy(s["cfg"], s["jstate0"], device="cpu")
    step = make_train_step(s["model"], s["opt"])
    data = Pipeline(s["dcfg"])
    per_step, sensitive = [], {}
    for t in range(1, K + 1):
        s1, m = step(s1, {k: torch.from_numpy(v)
                          for k, v in next(data).items()})
        per_step.append((float(m["loss"]), float(m["grad_norm"])))
        for n, v in s1["opt"]["v"].items():
            rms = torch.sqrt(v / (1 - s["opt"].b2 ** t))
            hit = (rms > 0) & (rms < s["opt"].eps)
            sensitive[n] = hit | sensitive.get(n, hit)
    data.close()
    np.testing.assert_allclose(np.asarray(per_step), np.asarray(jtraj),
                               rtol=2e-5, atol=1e-7)
    marked = total = 0
    for n, p in s1["params"].items():
        keep = ~sensitive[n].numpy()
        np.testing.assert_allclose(p.numpy()[keep],
                                   np.asarray(state["params"][n])[keep],
                                   rtol=2e-5, atol=1e-6, err_msg=n)
        marked += int((~keep).sum())
        total += keep.size
    assert marked <= 0.05 * total, (marked, total)


# --- the launcher -------------------------------------------------------------


def test_launcher_trains_granite_then_resumes_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--arch", GRANITE, "--reduced", "--layers",
            "2", "--seq", "32", "--steps", "4", "--steps-per-sync", "2",
            "--ckpt-dir", str(tmp_path)]
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert run.returncode == 0, run.stderr
    assert f"arch={GRANITE} layers=2" in run.stdout
    assert "step    4 loss" in run.stdout
    assert "  train_window_b8_s32_k2: energy vs SRAM" in run.stdout
    assert launch_train.main(args[:-5] + ["6"] + args[-4:]) == 0
    out = capsys.readouterr().out
    assert "restored step 4" in out and "done @6" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 6]

