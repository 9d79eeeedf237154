"""Training of the port's encdec family (whisper-tiny) against the JAX
package, on the CPU: the encoder in train mode (each layer under remat),
``Model.loss`` and every gradient on batches with frames (Se != S, so that
a swapped query and key length cannot pass) and on tokens alone (no
cross-attention: the ``xattn/*``, ``lnx/*`` and encoder weights get zero
gradients in both packages), trajectories against the JAX per-step oracle
with the unreached weights decayed as JAX's AdamW decays them, a
microbatched and a compressed step, the launcher and the example.

Weights: reduced whisper in f32, ``model.init(PRNGKey(0))`` through
``params_from_numpy``; inputs from a numpy seed.  Tolerances: the encoder's
output within 1e-4 (``tests/test_torch_encdec.py``'s), the loss within rel
1e-5 and every gradient within rtol 3e-4 / atol 3e-5
(``tests/test_torch_train.py``'s); trajectories within rel 2e-5 / atol
1e-7 on loss and grad_norm and params within rtol 2e-5 / atol 1e-6 (the
dense test's), with EF-int8 compression at most 2 elements one int8
quantum apart, bounded as there; the window bit for bit equal to the
per-step loop.
"""
import functools

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
from repro.models.transformer import \
    encoder_forward as jencoder_forward  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.train.trainer import effective_optimizer as jeffective  # noqa: E402,E501
from repro.train.trainer import init_state as jinit_state  # noqa: E402
from repro.train.trainer import make_train_step as jmake_train_step  # noqa: E402,E501
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import DataConfig, Pipeline  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (params_from_numpy,  # noqa: E402
                                        train_state_from_numpy)
from repro_torch.models.transformer import encoder_forward  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.train.trainer import (make_train_step,  # noqa: E402
                                       make_train_window)

ARCH = "whisper-tiny"
RTOL, ATOL = 3e-4, 3e-5
JIMPL = {"kernel": "chunked", "plain": "naive"}
S, SE = 40, 24          # tokens and frames: the cross geometry has Sq != Skv


def _unreached(name: str) -> bool:
    """The weights a batch without frames does not reach: the encoder's
    and each decoder layer's cross-attention and its LayerNorm."""
    return (name.startswith("enc_") or "/xattn/" in name
            or "/lnx/" in name)


@functools.lru_cache(maxsize=None)
def _models(remat="none"):
    jcfg = jreduced(jget_config(ARCH), dtype="float32", remat=remat)
    jmodel = jbuild_model(jcfg, max_seq=64)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(ARCH), dtype="float32", remat=remat)
    model = build_model(cfg, max_seq=64, device="cpu")
    nparams = {k: np.asarray(v) for k, v in jparams.items()}
    return jmodel, jparams, model, nparams


def _grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for n, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[n]),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


# --- the encoder in train mode -------------------------------------------------


@pytest.mark.parametrize("impl,remat", [("kernel", "full"),
                                        ("plain", "none")])
def test_encoder_train_forward_and_grads_match_jax(impl, remat):
    """``encoder_forward(train=True)`` (each layer under ``_remat``): the
    output within 1e-4 and the gradients of <out, w> (w seeded) with
    respect to the encoder's weights and the frames against ``jax.grad``
    of JAX's ``encoder_forward(train=True)``."""
    jmodel, jparams, model, nparams = _models(remat)
    rng = np.random.default_rng(5)
    D = model.cfg.d_model
    frames = rng.standard_normal((2, SE, D)).astype(np.float32)
    w = rng.standard_normal((2, SE, D)).astype(np.float32)
    enc = sorted(n for n in nparams if n.startswith("enc"))

    def jf(p, x):
        out = jencoder_forward(jmodel.cfg, dict(jparams, **p), x,
                               JIMPL[impl], train=True)
        return jnp.sum(out * w), out

    (_, jout), (jg, jgx) = jax.value_and_grad(jf, argnums=(0, 1),
                                              has_aux=True)(
        {n: jparams[n] for n in enc}, jnp.asarray(frames))
    params = params_from_numpy(model.cfg, nparams, device="cpu")
    leaves = {n: params[n].requires_grad_() for n in enc}
    x = torch.from_numpy(frames).requires_grad_()
    out = encoder_forward(model.cfg, dict(params, **leaves), x, impl,
                          train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-4)
    g = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                            [*leaves.values(), x])
    _grads_close(dict(zip(enc, g[:-1])), jg)
    np.testing.assert_allclose(g[-1].numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL, err_msg="frames")


# --- Model.loss and its gradients ------------------------------------------------


@pytest.mark.parametrize("source", ["frames", "tokens"])
@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_train_loss_and_grads_match_jax(impl, remat, source):
    """``Model.loss`` and every parameter's gradient against
    ``jax.value_and_grad(jmodel.loss)``, the flash route against JAX's
    "chunked" and the naive one against "naive": with 24 frames a row
    beside 40 tokens (the encoder, then the cross-attention at Sq 40, Skv
    24, under autograd), and on tokens alone, where the unreached weights'
    gradients are exactly 0 in both packages."""
    jmodel, jparams, model, nparams = _models(remat)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, model.cfg.vocab_size, (2, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if source == "frames":
        batch["frames"] = rng.standard_normal(
            (2, SE, model.cfg.d_model)).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()},
        attn_impl=JIMPL[impl])))(jparams)
    params = params_from_numpy(model.cfg, nparams, device="cpu")
    leaves = {n: p.requires_grad_() for n, p in params.items()}
    tl = model.loss(leaves, {k: torch.from_numpy(v)
                             for k, v in batch.items()}, attn_impl=impl)
    tg = torch.autograd.grad(tl, list(leaves.values()), allow_unused=True,
                             materialize_grads=True)
    tg = dict(zip(leaves, tg))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    _grads_close(tg, jg)
    unreached = sorted(n for n in tg if _unreached(n))
    assert unreached and any("/xattn/" in n for n in unreached)
    for n in unreached:
        zero = source == "tokens"
        assert bool((tg[n] == 0).all()) == zero, n
        assert bool((np.asarray(jg[n]) == 0).all()) == zero, n


# --- trajectories against the JAX per-step oracle --------------------------------

SEQ, BATCH, STEPS = 16, 4, 3
COMPRESSED = {"compress_grads": True, "compress_shards": 2}


@functools.lru_cache(maxsize=None)
def _setup():
    """Tiny whisper (2 + 2 layers, d_model 32), AdamW at weight decay 0.1
    (the default), so that the weights the tokens-only batches do not reach
    shrink by lr x 0.1 a step in both packages."""
    over = dict(dtype="float32", d_model=32, num_heads=2, num_kv_heads=2,
                head_dim=16, d_ff=64, vocab_size=128)
    jcfg = jreduced(jget_config(ARCH), **over)
    jmodel = jbuild_model(jcfg, max_seq=SEQ)
    jopt = JAdamW(lr=jconstant(1e-3))
    cfg = reduced(get_config(ARCH), **over)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return dict(jmodel=jmodel, jopt=jopt, jparams=jparams, cfg=cfg,
                model=build_model(cfg, max_seq=SEQ, device="cpu"),
                opt=AdamW(lr=constant(1e-3)),
                dcfg=DataConfig(cfg.vocab_size, SEQ, BATCH))


def _jstate0(s, kw):
    opt = jeffective(s["jopt"], bool(kw.get("compress_grads")),
                     kw.get("compress_shards", 1))
    return jax.tree.map(np.asarray, jinit_state(s["jmodel"], opt,
                                                jax.random.PRNGKey(0)))


def _jax_oracle(s, steps, **kw):
    """(loss, grad_norm) and the params after each of ``steps`` jitted JAX
    steps on the JAX pipeline's batches."""
    state = jax.tree.map(jnp.asarray, _jstate0(s, kw))
    fn = jax.jit(jmake_train_step(s["jmodel"], s["jopt"], **kw))
    data = JPipeline(JDataConfig(s["cfg"].vocab_size, SEQ, BATCH))
    out, params = [], []
    for _ in range(steps):
        state, m = fn(state, jax.tree.map(jnp.asarray, next(data)))
        out.append((float(m["loss"]), float(m["grad_norm"])))
        params.append(jax.tree.map(np.asarray, state["params"]))
    data.close()
    return out, params


def _port_per_step(s, steps, **kw):
    state = train_state_from_numpy(s["cfg"], _jstate0(s, kw), device="cpu")
    fn = make_train_step(s["model"], s["opt"], **kw)
    data = Pipeline(s["dcfg"])
    out, params = [], []
    for _ in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        state, m = fn(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
        params.append({n: p.clone() for n, p in state["params"].items()})
    data.close()
    return out, params, state


def _adam_step_bound(b1: float, b2: float, t: int) -> float:
    """The largest |m_hat / sqrt(v_hat)| Adam can take at step t, over any
    gradients (Cauchy-Schwarz on m against v)."""
    acc = sum((b1 * b1 / b2) ** k for k in range(t))
    return ((1 - b1) * acc ** 0.5 / (1 - b2) ** 0.5
            * (1 - b2 ** t) ** 0.5 / (1 - b1 ** t))


def _params_close(got: dict, want: dict, flip_bound=None) -> int:
    """Every parameter within rtol 2e-5 / atol 1e-6; with ``flip_bound``
    the elements outside (one int8 quantum apart under compression) are
    counted and each held within it."""
    flipped = 0
    for n, p in got.items():
        g, w = p.numpy(), np.asarray(want[n])
        off = np.abs(g - w) > 1e-6 + 2e-5 * np.abs(w)
        if flip_bound is None:
            assert not off.any(), (n, np.abs(g - w).max())
        else:
            flipped += int(off.sum())
            np.testing.assert_array_less(np.abs(g - w)[off], flip_bound,
                                         err_msg=n)
    return flipped


def test_trajectories_match_jax_oracle_and_window_is_bitwise():
    """3 tokens-only steps: loss, grad_norm and every parameter after each
    step against the jitted JAX step; the unreached weights moved by the
    decay alone, (1 - lr x wd)^3 of their initial values; the window of 3
    equal to the per-step loop bit for bit."""
    s = _setup()
    jtraj, jparams = _jax_oracle(s, STEPS)
    per_step, params, s1 = _port_per_step(s, STEPS)
    np.testing.assert_allclose(np.asarray(per_step), np.asarray(jtraj),
                               rtol=2e-5, atol=1e-7)
    for got, want in zip(params, jparams):
        _params_close(got, want)
    decay = (1 - 1e-3 * s["opt"].weight_decay) ** STEPS
    p0 = s["jparams"]
    unreached = [n for n in params[-1] if _unreached(n)]
    assert any("/xattn/" in n for n in unreached)
    for n in unreached:
        np.testing.assert_allclose(params[-1][n].numpy(),
                                   np.asarray(p0[n]) * decay, rtol=1e-6,
                                   atol=1e-9, err_msg=n)
        assert not np.array_equal(params[-1][n].numpy(), np.asarray(p0[n])) \
            or not np.asarray(p0[n]).any(), n
    win = make_train_window(s["model"], s["opt"], steps_per_sync=STEPS,
                            data_cfg=s["dcfg"])
    s2, m = win(train_state_from_numpy(s["cfg"], _jstate0(s, {}),
                                       device="cpu"))
    assert list(zip(m["loss"].tolist(), m["grad_norm"].tolist())) \
        == per_step                          # bitwise: same tokens, step
    for n, p in s1["params"].items():
        assert torch.equal(p, s2["params"][n]), n
    assert int(s1["step"]) == int(s2["step"]) == STEPS


@pytest.mark.parametrize("kw", [{"microbatches": 2}, COMPRESSED],
                         ids=["microbatched", "compressed"])
def test_microbatched_and_compressed_steps_match_jax_oracle(kw):
    """2 tokens-only steps in 2 microbatches, and with EF-int8 compression
    over 2 shard groups (the unreached weights' zero gradients quantized
    and banked as JAX's), against the JAX oracle: loss and grad_norm at
    the trajectory bounds, every parameter within them or, compressed, at
    most 2 elements one quantum apart and each within twice Adam's
    largest step a step; the error buffers finite."""
    s = _setup()
    steps = 2
    jtraj, jparams = _jax_oracle(s, steps, **kw)
    per_step, params, state = _port_per_step(s, steps, **kw)
    np.testing.assert_allclose(np.asarray(per_step), np.asarray(jtraj),
                               rtol=2e-5, atol=1e-7)
    opt = s["opt"]
    flip = None
    if kw.get("compress_grads"):
        flip = 2 * 1e-3 * steps * _adam_step_bound(opt.b1, opt.b2, steps)
        for n, e in state["opt"]["err"].items():
            assert bool(torch.isfinite(e).all()), n
    flipped = sum(_params_close(got, want, flip)
                  for got, want in zip(params, jparams))
    assert flipped <= 2, flipped


# --- the launcher and the example ------------------------------------------------


def test_launcher_trains_whisper_on_cpu(tmp_path, capsys):
    """``launch.train --arch whisper-tiny --reduced``: one window of 4
    steps on the token stream, the step line and the train verdict line."""
    assert launch_train.main([
        "--device", "cpu", "--arch", ARCH, "--reduced", "--seq", "32",
        "--steps", "4", "--steps-per-sync", "4", "--ckpt-dir",
        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} " in out and "d_model=128" in out
    assert "step    4 loss" in out and "done @4" in out
    assert "  train_window_b8_s32_k4: energy vs SRAM" in out


def test_launcher_refuses_layers_for_encdec_before_any_weight(monkeypatch):
    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(launch_train, "build_model", no_model)
    with pytest.raises(ValueError, match="enc_layers 4, dec_layers 4"):
        launch_train.main(["--device", "cpu", "--arch", ARCH, "--layers",
                           "2"])
    with pytest.raises(ValueError, match="enc_layers"):
        launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced",
                           "--layers", "2"])


def test_train_lm_example_trains_whisper_on_cpu(tmp_path, capsys):
    assert train_lm.main(["--device", "cpu", "--arch", ARCH, "--seq", "32",
                          "--steps", "4", "--steps-per-sync", "2",
                          "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "step    4  loss" in out and "done; final loss" in out
    assert "train_window_b8_s32_k2: energy vs SRAM" in out
