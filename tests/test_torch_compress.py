"""The port's EF-int8 gradient compressor (``repro_torch.optim.compress``)
against the JAX package's (``repro.optim.compress``), on the CPU.

Bit for bit: ``quantize`` / ``dequantize`` (f32 and bf16), 50 steps of
``apply_error_feedback``, ``compressed_psum`` / ``compressed_psum_ef``
over 1, 2 and 4 shards against ``jax.vmap(..., axis_name="dp")`` of the
JAX functions, and the wrapped optimizer's error buffers.  The JAX side
runs op by op (each op rounds its result, as each torch op does): under
``jax.jit`` XLA:CPU contracts the residual ``x - q * scale`` into one
fused multiply-add, which rounds once and so differs from both in the
last bit of most residuals (the train-step tests, which hold the port to
the jitted JAX step, carry that).  The wrapped optimizer's parameters
within the AdamW test's rtol 1e-6.  Then the port's twins of the JAX
package's own compression tests (``tests/test_runtime.py``,
``tests/test_train_stack.py``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import compress as jc  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.optim import compress as tc  # noqa: E402


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    got = _np(t)
    assert got.dtype == j.dtype and got.shape == j.shape
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                  j.reshape(-1).view(np.uint8))


QUANT_CASES = {
    "seed0 (5, 7)": (np.random.default_rng(0).standard_normal((5, 7)) * 3),
    "seed1 (1000,)": np.random.default_rng(1).standard_normal(1000),
    "seed2 (2, 4, 6)": (np.random.default_rng(2).standard_normal((2, 4, 6))
                        * 1e-4),
    "seed3 0-d": np.asarray(np.random.default_rng(3).standard_normal()),
    "all zero": np.zeros((4, 4)),              # scale 1e-12, every q 0
    # scale 127 / 127 + 1e-12 = 1.0 in f32: exact .5 ties round to even
    "ties": np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0]),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(QUANT_CASES))
def test_quantize_dequantize_bitwise(case, dtype):
    x = QUANT_CASES[case].astype(np.float32).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    jq, js = jc.quantize(jnp.asarray(x))
    tq, ts = tc.quantize(_t(x))
    _same(tq, jq)
    _same(ts, js)                 # the scale in x's dtype, as in JAX
    _same(tc.dequantize(tq, ts), jc.dequantize(jq, js))
    if case == "ties":
        assert tq.tolist()[:6] == [0, 2, 2, 0, -2, -2]


def test_apply_error_feedback_bitwise_over_50_steps():
    rng = np.random.default_rng(4)
    shapes = {"a": (8, 9), "b/c": (3,)}
    je = jc.init_error_state({n: jnp.zeros(s) for n, s in shapes.items()})
    te = tc.init_error_state({n: torch.zeros(s) for n, s in shapes.items()})
    for step in range(50):
        g = {n: (rng.standard_normal(s) * (1 + step % 7)).astype(np.float32)
             for n, s in shapes.items()}
        jcomp, je = jc.apply_error_feedback(
            {n: jnp.asarray(a) for n, a in g.items()}, je)
        tcomp, te = tc.apply_error_feedback(
            {n: torch.from_numpy(a) for n, a in g.items()}, te)
        for n in shapes:
            _same(tcomp[n], jcomp[n])
            _same(te[n], je[n])


@pytest.mark.parametrize("mean", [False, True], ids=["sum", "mean"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_compressed_psum_matches_jax_vmap(shards, mean):
    rng = np.random.default_rng(5 + shards)
    x = {"g": rng.standard_normal((shards, 6, 5)).astype(np.float32),
         "h": (rng.standard_normal((shards, 3)) * 50).astype(np.float32)}
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.from_numpy(v) for k, v in x.items()}
    jcomb, jerr = jax.vmap(lambda t: jc.compressed_psum_ef(t, "dp",
                                                           mean=mean),
                           axis_name="dp")(jx)
    jsum = jax.vmap(lambda t: jc.compressed_psum(t, "dp", mean=mean),
                    axis_name="dp")(jx)
    tcomb, terr = tc.compressed_psum_ef(tx, mean=mean)
    tsum = tc.compressed_psum(tx, mean=mean)
    for k in x:
        for i in range(shards):           # JAX's rows are replicated
            _same(tcomb[k], jcomb[k][i])
            _same(tsum[k], jsum[k][i])
        _same(terr[k], jerr[k])
        assert torch.equal(tx[k], torch.from_numpy(x[k]))   # input kept


def test_compressed_psum_sum_vs_mean_contract():
    """The port's twin of ``tests/test_train_stack.py``'s test."""
    shards = 4
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (shards, 32)).astype(np.float32))
    s = tc.compressed_psum({"g": x})["g"]
    m = tc.compressed_psum({"g": x}, mean=True)["g"]
    tol = float(x.abs().max()) / 127 * shards + 1e-6
    np.testing.assert_allclose(s.numpy(), x.sum(0).numpy(), atol=tol)
    np.testing.assert_allclose(m.numpy(), x.mean(0).numpy(),
                               atol=tol / shards + 1e-6)
    np.testing.assert_allclose((s / shards).numpy(), m.numpy(), rtol=1e-6)


@pytest.mark.parametrize("shards", [1, 2])
def test_compressed_optimizer_update_matches_jax(shards):
    """Three updates fed the same gradients (per-shard stacked at 2
    shards; clipped, then not): the error buffers bit for bit, params, m
    and v within rtol 1e-6, the metrics too, and the state's layout."""
    rng = np.random.default_rng(6)
    shapes = {"a": (5, 7), "b/c": (3,), "d": (2, 4, 6)}
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    kw = dict(weight_decay=0.1, clip_norm=1.0)
    jopt = jc.wrap_optimizer(JAdamW(lr=jconstant(1e-2), **kw), shards)
    topt = tc.wrap_optimizer(AdamW(lr=constant(1e-2), **kw), shards)
    jp = {n: jnp.asarray(a) for n, a in p0.items()}
    js = jopt.init(jp)
    tp = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    ts = topt.init(tp)
    lead = (shards,) if shards > 1 else ()
    assert set(ts) == {"inner", "err"}
    assert {n: tuple(e.shape) for n, e in ts["err"].items()} == \
        {n: lead + s for n, s in shapes.items()}
    for step, gscale in enumerate((5.0, 0.01, 1.0)):
        g = {n: (gscale * rng.standard_normal(lead + s)).astype(np.float32)
             for n, s in shapes.items()}
        jp, js, jm = jopt.update({n: jnp.asarray(a) for n, a in g.items()},
                                 js, jp)
        tm = topt.update({n: torch.from_numpy(a) for n, a in g.items()}, ts,
                         tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for n in shapes:
            _same(ts["err"][n], js["err"][n])
            for what, t, j in (("params", tp, jp),
                               ("m", ts["inner"]["m"], js["inner"]["m"]),
                               ("v", ts["inner"]["v"], js["inner"]["v"])):
                np.testing.assert_allclose(t[n].numpy(), np.asarray(j[n]),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"{what} {n} {step}")
    assert int(ts["inner"]["count"]) == 3


def test_compressed_optimizer_refuses_misshaped_gradients():
    opt = tc.wrap_optimizer(AdamW(lr=constant(1e-2)), shards=2)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    with pytest.raises(ValueError, match="gradient shape"):
        opt.update({"w": torch.ones(3)}, state, params)   # no shard axis


def test_wrap_optimizer_rejects_zero_shards():
    with pytest.raises(ValueError, match="shards must be >= 1"):
        tc.wrap_optimizer(AdamW(lr=constant(1e-2)), shards=0)


# --- twins of the JAX package's own compression tests ---------------------


def test_quantize_roundtrip_bound():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32))
    q, s = tc.quantize(x)
    err = (tc.dequantize(q, s) - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-9


def test_error_feedback_unbiased_over_steps():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        128).astype(np.float32))}
    err = tc.init_error_state(g)
    total = torch.zeros(128)
    steps = 50
    for _ in range(steps):
        comp, err = tc.apply_error_feedback(g, err)
        total = total + comp["w"]
    np.testing.assert_allclose((total / steps).numpy(), g["w"].numpy(),
                               atol=2e-3)


def test_wrap_optimizer_state_and_convergence():
    opt = tc.wrap_optimizer(AdamW(lr=constant(0.1), weight_decay=0.0))
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    assert set(state) == {"inner", "err"}           # EF rides in opt state
    assert state["err"]["w"].shape == (2,)
    for _ in range(200):
        m = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1e-2
    assert float(m["grad_norm"]) >= 0               # inner metrics surface


class _Probe:
    """Inner-optimizer probe: sums the (compressed) gradients it is fed,
    so that a test sees what the EF wrapper delivers."""

    def init(self, params):
        return {"seen": {n: torch.zeros(p.shape) for n, p in params.items()},
                "n": torch.zeros(())}

    def update(self, grads, state, params):
        for n, g in grads.items():
            state["seen"][n] += g
        state["n"] += 1
        return {}


def test_wrap_optimizer_error_feedback_bias_vanishes():
    opt = tc.wrap_optimizer(_Probe())
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        128).astype(np.float32))}
    params = {"w": torch.zeros(128)}
    state = opt.init(params)
    steps = 50
    for _ in range(steps):
        opt.update(dict(g), state, params)   # update consumes the dict
    mean_seen = state["inner"]["seen"]["w"].numpy() / steps
    np.testing.assert_allclose(mean_seen, g["w"].numpy(), atol=2e-3)


def test_wrap_optimizer_sharded_ef_bias_vanishes():
    shards = 4
    opt = tc.wrap_optimizer(_Probe(), shards=shards)
    g = {"w": torch.from_numpy(np.random.default_rng(3).standard_normal(
        (shards, 64)).astype(np.float32))}
    params = {"w": torch.zeros(64)}
    state = opt.init(params)
    assert state["err"]["w"].shape == (shards, 64)  # per-worker buffers
    steps = 50
    for _ in range(steps):
        opt.update(dict(g), state, params)   # update consumes the dict
    mean_seen = state["inner"]["seen"]["w"].numpy() / steps
    np.testing.assert_allclose(mean_seen, g["w"].mean(0).numpy(), atol=2e-3)


def test_wrap_optimizer_error_feedback_carries():
    opt = tc.wrap_optimizer(AdamW(lr=constant(0.0), weight_decay=0.0,
                                  clip_norm=0.0))
    params = {"w": torch.zeros(2)}
    state = opt.init(params)
    opt.update({"w": torch.tensor([1000.0, 1e-3])}, state, params)
    err = float(state["err"]["w"][1])
    assert err != 0.0                     # the lost mass is banked
    opt.update({"w": torch.zeros(2)}, state, params)
    assert abs(float(state["err"]["w"][1])) <= abs(err) + 1e-9
