"""Training of the port's ssm (mamba2) and hybrid (recurrentgemma) families
against the JAX package, on the CPU: the two scans under autograd
(``ops.SSDScan``, ``ops.RGLRUGatedScan``) against ``jax.grad`` of the JAX
model's scans, the RG-LRU reverse-scan adjoint against plain autograd,
train-mode ``Model.loss`` and its gradients, K-step trajectories against
the JAX per-step oracle, and the launcher.

On CPU tensors both functions run their kernel's plain version forward
and the same backward as on the card: the SSD chunks recomputed under
autograd from their entering states, the RG-LRU adjoint as two runs of the ungated
recurrence (``rglru_scan_plain`` here, the CUDA kernel there).

Tolerances: the scans' gradients and the loss's within rtol 3e-4 / atol
3e-5 of JAX (``tests/test_models.py``'s flash-vjp bounds), the scans'
outputs within the JAX scan tests' f32 1e-4 and the loss within rel 1e-5
(``tests/test_torch_train.py``'s); the adjoint within 2e-5
of plain autograd of the plain scan (the same sums in another order); the
trajectories within rel 2e-5 / atol 1e-7 on loss and grad_norm and params
within rtol 2e-5 / atol 1e-6 of the JAX oracle (the dense test's bounds),
the window bit for bit equal to the per-step loop.
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
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.train.trainer import init_state as jinit_state  # noqa: E402
from repro.train.trainer import make_train_step as jmake_train_step  # noqa: E402,E501
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model, ssm  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        train_state_from_numpy)
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.train.trainer import (make_train_step,  # noqa: E402
                                       make_train_window)

RTOL, ATOL = 3e-4, 3e-5
ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _sigmoid(a):
    return (1 / (1 + np.exp(-a))).astype(np.float32)


def _outputs_close(got, want):
    """The forward outputs within the JAX scan tests' f32 bound, 1e-4."""
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def _grads_close(got, want, names):
    for g, w, n in zip(got, want, names):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=f"d{n}")


# --- the RG-LRU scan under autograd -------------------------------------------


@pytest.mark.parametrize("with_h0", [False, True], ids=["h0=0", "h0"])
@pytest.mark.parametrize("S", [64, 512], ids=["assoc", "blocked"])
def test_rglru_gated_scan_grads_match_jax(S, with_h0):
    """``RGLRUGatedScan`` against ``jax.grad`` of the JAX model's
    ``rglru_scan``: its single associative scan (S <= 256) and its blocked
    path (S > 256, S % 256 == 0), with and without h0, through a loss that
    reads y and the final state."""
    rng = np.random.default_rng(21)
    B, R = 2, 16
    xs = [_rand(rng, (B, S, R)), _sigmoid(_rand(rng, (B, S, R))),
          _sigmoid(_rand(rng, (B, S, R))), _rand(rng, (R,)),
          _rand(rng, (B, R))]
    wy, wh = _rand(rng, (B, S, R)), _rand(rng, (B, R))
    n = 5 if with_h0 else 4

    def jloss(*a):
        y, h = jrglru.rglru_scan(*a[:4], a[4] if with_h0 else None)
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)

    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(n)), has_aux=True)(
            *map(jnp.asarray, xs[:n]))
    ts = [torch.from_numpy(a).requires_grad_() for a in xs[:n]]
    y, h = ops.RGLRUGatedScan.apply(*ts[:4], ts[4] if with_h0 else None)
    tl = (y * torch.from_numpy(wy)).sum() + (h * torch.from_numpy(wh)).sum()
    tg = torch.autograd.grad(tl, ts)
    _outputs_close((y, h), jout)
    _grads_close(tg, jg, ["x", "r", "i", "lam", "h0"])
    assert ops.launches["rglru_scan"] == 0      # CPU: the plain versions


@pytest.mark.parametrize("dh_final", [False, True], ids=["dh=0", "dh"])
def test_rglru_adjoint_mirror_matches_plain_autograd(dh_final):
    """``rglru_gated_scan_backward`` with ``rglru_scan_plain`` standing in
    for the ungated kernel (what the card runs: h again, then the adjoint
    as the reversed recurrence with dh_final as its initial state) equals
    plain autograd of ``rglru_gated_scan_plain``."""
    rng = np.random.default_rng(22)
    B, S, R = 3, 40, 8
    xs = [torch.from_numpy(a).requires_grad_() for a in (
        _rand(rng, (B, S, R)), _sigmoid(_rand(rng, (B, S, R))),
        _sigmoid(_rand(rng, (B, S, R))), _rand(rng, (R,)),
        _rand(rng, (B, R)))]
    dy = torch.from_numpy(_rand(rng, (B, S, R)))
    dh = torch.from_numpy(_rand(rng, (B, R)) if dh_final
                          else np.zeros((B, R), np.float32))
    y, h = rg.rglru_gated_scan_plain(*xs)
    want = torch.autograd.grad((y, h), xs, (dy, dh))
    got = rg.rglru_gated_scan_backward(
        rg.rglru_scan_plain, *(t.detach() for t in xs), dy, dh)
    for g, w, n in zip(got, want, ["x", "r", "i", "lam", "h0"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=f"d{n}")
    assert rg.rglru_gated_scan_backward(
        rg.rglru_scan_plain, *(t.detach() for t in xs[:4]), None, dy,
        dh)[4] is None


# --- the SSD scan under autograd ----------------------------------------------


@pytest.mark.parametrize("with_s0", [False, True], ids=["s0=0", "s0"])
def test_ssd_scan_grads_match_jax(with_s0):
    """``ssd_chunked`` under grad (``SSDScan``: plain forward on the CPU,
    the chunks recomputed under autograd in the backward) against ``jax.grad`` of the
    JAX model's ``ssd_chunked``, with and without an initial state,
    through a loss that reads y and the final state."""
    rng = np.random.default_rng(23)
    b, S, H, P, N, chunk = 2, 64, 3, 8, 4, 16
    dt = np.log1p(np.exp(_rand(rng, (b, S, H)) - 1.0)).astype(np.float32)
    xs = [_rand(rng, (b, S, H, P)), dt, -np.exp(_rand(rng, (H,), 0.5)),
          _rand(rng, (b, S, N), 0.3), _rand(rng, (b, S, N), 0.3),
          _rand(rng, (b, H, P, N))]
    wy, ws = _rand(rng, (b, S, H, P)), _rand(rng, (b, H, P, N))
    n = 6 if with_s0 else 5

    def jloss(*a):
        y, s = jssm.ssd_chunked(*a[:5], chunk,
                                initial_state=a[5] if with_s0 else None)
        return jnp.sum(y * wy) + jnp.sum(s * ws), (y, s)

    (_, jout), jg = jax.value_and_grad(
        jloss, argnums=tuple(range(n)), has_aux=True)(
            *map(jnp.asarray, xs[:n]))
    ts = [torch.from_numpy(np.asarray(a, np.float32)).requires_grad_()
          for a in xs[:n]]
    y, s = ssm.ssd_chunked(*ts[:5], chunk,
                           initial_state=ts[5] if with_s0 else None)
    tl = (y * torch.from_numpy(wy)).sum() + (s * torch.from_numpy(ws)).sum()
    tg = torch.autograd.grad(tl, ts)
    _outputs_close((y, s), jout)
    _grads_close(tg, jg, ["x", "dt", "A", "B", "C", "s0"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_equals_plain_autograd(dtype):
    """``SSDScan``'s gradients are plain autograd's of ``ssd_scan_plain``
    at the saved inputs (f32 2e-5; bf16 inputs 2e-2); an unused final
    state's gradient is zeros, and an unused s0 gets none."""
    rng = np.random.default_rng(24)
    b, S, H, P, N, chunk = 2, 48, 2, 8, 4, 16
    dt = np.log1p(np.exp(_rand(rng, (b, S, H)) - 1.0)).astype(np.float32)
    xs = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (
        _rand(rng, (b, S, H, P)), dt, -dt, _rand(rng, (b, S, N), 0.3),
        _rand(rng, (b, S, N), 0.3))]
    dy = torch.from_numpy(_rand(rng, (b, S, H, P))).to(dtype)
    y, _ = ssd.ssd_scan_plain(*xs, chunk=chunk)
    want = torch.autograd.grad(y, xs, dy)
    y, s = ops.SSDScan.apply(*xs, chunk, None)
    got = torch.autograd.grad(y, xs, dy)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("with_s0", [False, True], ids=["s0=0", "s0"])
@pytest.mark.parametrize("per", [1, 2, 3])
def test_ssd_backward_in_groups_of_chunks_equals_all_at_once(
        monkeypatch, per, with_s0):
    """Capping ``GROUP_ELEMENTS`` to ``per`` chunks a group (5 chunks: a
    last group shorter than the others when per is 2 or 3) gives the
    gradients of every chunk at once within 2e-5 (f32), with dh_final
    and ds0 in play."""
    rng = np.random.default_rng(25)
    b, S, H, P, N, chunk = 2, 40, 2, 8, 4, 8
    dt = np.log1p(np.exp(_rand(rng, (b, S, H)) - 1.0)).astype(np.float32)
    xs = [torch.from_numpy(a) for a in (
        _rand(rng, (b, S, H, P)), dt, -dt, _rand(rng, (b, S, N), 0.3),
        _rand(rng, (b, S, N), 0.3))]
    s0 = torch.from_numpy(_rand(rng, (b, H, P, N))) if with_s0 else None
    dy = torch.from_numpy(_rand(rng, (b, S, H, P)))
    ds = torch.from_numpy(_rand(rng, (b, H, P, N)))
    want = ssd.ssd_scan_backward(*xs, chunk, s0, dy, ds)
    monkeypatch.setattr(ssd, "GROUP_ELEMENTS", per * b * chunk * chunk * H)
    got = ssd.ssd_scan_backward(*xs, chunk, s0, dy, ds)
    assert (got[-1] is None) == (not with_s0)
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5,
                                       atol=2e-5)


# --- the train-mode model -----------------------------------------------------


def _models(arch, remat="none", **over):
    jcfg = jreduced(jget_config(arch), dtype="float32", **over)
    jmodel = jbuild_model(jcfg, max_seq=64)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch), dtype="float32", remat=remat, **over)
    model = build_model(cfg, max_seq=64, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("arch,impl,remat", [
    ("mamba2-1.3b", "kernel", "none"), ("mamba2-1.3b", "kernel", "full"),
    ("mamba2-1.3b", "plain", "none"),
    ("recurrentgemma-2b", "kernel", "none"),
    ("recurrentgemma-2b", "kernel", "full"),
    ("recurrentgemma-2b", "plain", "full"),
])
def test_train_loss_and_grads_match_jax(arch, impl, remat):
    """Reduced mamba2 (2 chunks a layer) and recurrentgemma (R, R, A;
    window 32 < S): ``Model.loss`` and every parameter's gradient against
    JAX's ``Model.loss`` under ``jax.value_and_grad``."""
    jmodel, jparams, model, params = _models(arch, remat)
    toks = np.random.default_rng(2).integers(0, 512, (2, 65)).astype(
        np.int32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:])}
    jimpl = {"kernel": "chunked", "plain": "naive"}[impl]
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jbatch, attn_impl=jimpl)))(jparams)
    leaves = {n: p.requires_grad_() for n, p in params.items()}
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    tl = model.loss(leaves, batch, attn_impl=impl)
    tg = torch.autograd.grad(tl, list(leaves.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grads_close(tg, [jg[n] for n in leaves], list(leaves))


# --- trajectories against the JAX per-step oracle ----------------------------

SEQ, BATCH, K = 16, 4, 4


@functools.lru_cache(maxsize=None)
def _setup(arch, eps=1e-6):
    over = dict(dtype="float32", num_layers=2, d_model=32, vocab_size=128)
    if arch == "mamba2-1.3b":
        over.update(ssm_heads=2, ssm_chunk=8)      # 2 chunks of the scan
    else:
        over.update(num_layers=3, lru_width=32, d_ff=64, local_window=8)
    jcfg = jreduced(jget_config(arch), **over)
    jmodel = jbuild_model(jcfg, max_seq=SEQ)
    # eps 1e-6, not the default 1e-8, unless asked: an element whose
    # gradient is near eps moves by lr x (its gradient's f32 roundoff) /
    # eps, and at 1e-8 that alone passes atol 1e-6 (a 1.5e-8 gradient of
    # ln1/g, 1e-9 apart in the two packages, moved by 1.1e-5 in 4 steps);
    # test_trajectories_at_the_default_eps_match_jax_oracle runs 1e-8
    jopt = JAdamW(lr=jconstant(1e-3), weight_decay=0.0, eps=eps)
    cfg = reduced(get_config(arch), **over)
    jstate0 = jax.tree.map(np.asarray,
                           jinit_state(jmodel, jopt, jax.random.PRNGKey(0)))
    return dict(jmodel=jmodel, jopt=jopt, jstate0=jstate0, cfg=cfg,
                model=build_model(cfg, max_seq=SEQ, device="cpu"),
                opt=AdamW(lr=constant(1e-3), weight_decay=0.0, eps=eps),
                dcfg=DataConfig(cfg.vocab_size, SEQ, BATCH))


def _jax_oracle(s, steps, **kw):
    state = jax.tree.map(jnp.asarray, s["jstate0"])
    fn = jax.jit(jmake_train_step(s["jmodel"], s["jopt"], **kw))
    data = JPipeline(JDataConfig(s["cfg"].vocab_size, SEQ, BATCH))
    out = []
    for _ in range(steps):
        state, m = fn(state, jax.tree.map(jnp.asarray, next(data)))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    data.close()
    return out, state


def _port_per_step(s, steps, sensitive=None, **kw):
    """The port's per-step loop from the JAX initial state.  With
    ``sensitive`` (a dict of bool tensors), marks in it each parameter
    element whose Adam RMS gradient sqrt(v_hat) lay in (0, eps) at some
    step."""
    state = train_state_from_numpy(s["cfg"], s["jstate0"], device="cpu")
    fn = make_train_step(s["model"], s["opt"], **kw)
    data = Pipeline(s["dcfg"])
    out = []
    for t in range(1, steps + 1):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        state, m = fn(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        if sensitive is not None:
            for n, v in state["opt"]["v"].items():
                rms = torch.sqrt(v / (1 - s["opt"].b2 ** t))
                hit = (rms > 0) & (rms < s["opt"].eps)
                sensitive[n] = hit | sensitive.get(n, hit)
    data.close()
    return out, state


@pytest.mark.parametrize("kw", [{}, {"microbatches": 2}],
                         ids=["plain", "microbatched"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trajectories_match_jax_oracle_and_window_is_bitwise(arch, kw):
    s = _setup(arch)
    jtraj, jstate = _jax_oracle(s, K, **kw)
    per_step, s1 = _port_per_step(s, K, **kw)
    win = make_train_window(s["model"], s["opt"], steps_per_sync=K,
                            data_cfg=s["dcfg"], **kw)
    s2, m = win(train_state_from_numpy(s["cfg"], s["jstate0"], device="cpu"))
    np.testing.assert_allclose(np.asarray(per_step), np.asarray(jtraj),
                               rtol=2e-5, atol=1e-7)
    assert list(zip(m["loss"].tolist(), m["grad_norm"].tolist())) \
        == per_step                          # bitwise: same tokens, step
    for n, p in s1["params"].items():
        assert torch.equal(p, s2["params"][n]), n
        np.testing.assert_allclose(p.numpy(), np.asarray(jstate["params"][n]),
                                   rtol=2e-5, atol=1e-6, err_msg=n)
    assert int(s1["step"]) == int(s2["step"]) == K


# An element whose RMS gradient sqrt(v_hat) lies below Adam's eps moves by
# lr x g / eps, so the roundoff of its gradient reaches the weight
# multiplied by lr / eps = 1e5 at eps 1e-8 (a 2.3e-9 RMS gradient of
# mamba2's ln1/g ends 1e-5 apart in the two packages); the other elements
# agree at the dense test's bounds
def _params_close_where_insensitive(state, jstate, sensitive):
    """Params within the dense test's bounds on every element that
    ``_port_per_step`` did not mark; at most 5% of them marked (0.02% of
    mamba2's elements, 0.03% of recurrentgemma's, 2.4% of granite's,
    whose experts see few tokens)."""
    marked = total = 0
    for n, p in state["params"].items():
        keep = ~sensitive[n].numpy()
        np.testing.assert_allclose(p.numpy()[keep],
                                   np.asarray(jstate["params"][n])[keep],
                                   rtol=2e-5, atol=1e-6, err_msg=n)
        marked += int((~keep).sum())
        total += keep.size
    assert marked <= 0.05 * total, (marked, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_trajectories_at_the_default_eps_match_jax_oracle(arch):
    """AdamW at its default eps 1e-8: loss and grad_norm over K steps at
    the dense test's bounds, and the params at its bounds on every element
    whose RMS gradient stayed out of (0, eps) (an element with no gradient
    yet is not moved in either package)."""
    s = _setup(arch, eps=1e-8)
    jtraj, jstate = _jax_oracle(s, K)
    sensitive = {}
    per_step, state = _port_per_step(s, K, sensitive=sensitive)
    np.testing.assert_allclose(np.asarray(per_step), np.asarray(jtraj),
                               rtol=2e-5, atol=1e-7)
    _params_close_where_insensitive(state, jstate, sensitive)


# --- the launcher -------------------------------------------------------------


def test_launcher_trains_mamba2_then_resumes_on_cpu(tmp_path, capsys):
    args = ["--device", "cpu", "--arch", "mamba2-1.3b", "--reduced",
            "--layers", "2", "--seq", "32", "--steps", "4",
            "--steps-per-sync", "2", "--ckpt-dir", str(tmp_path)]
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert run.returncode == 0, run.stderr
    assert "arch=mamba2-1.3b layers=2" in run.stdout
    assert "step    4 loss" in run.stdout
    assert "  train_window_b8_s32_k2: energy vs SRAM" in run.stdout
    assert launch_train.main(args[:-5] + ["6"] + args[-4:]) == 0
    out = capsys.readouterr().out
    assert "restored step 4" in out and "done @6" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [4, 6]
