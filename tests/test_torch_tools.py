"""The port's calibration tools (``repro_torch.tools``) against the JAX
package's (``tools/calibrate_cache.py``, ``tools/calibrate_traffic.py``,
loaded from their files, unedited), on the CPU.

Tolerances: the cache tool's per-step losses within rel 1e-6 of the JAX
loop's (``tests/test_torch_nvm.py``'s REL: the loss and its gradient are
held there at 1e-6 and 1e-4, and Adam's first steps are nearly
scale-free, so the two trajectories keep the same Algorithm-1 selections
and stay within 3e-7 over 20 steps); the traffic tool's first update
within rtol 1e-6 of one JAX ``AdamW`` step on the forward-mode gradient
(the gradient the port follows; ``jax.grad``, which the JAX tool
follows, disagrees with it on five of six knobs).
"""
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.core import traffic as jtraffic  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro_torch.core import traffic  # noqa: E402
from repro_torch.tools import adam_fit, calibrate_cache, calibrate_traffic  # noqa: E402,E501

# the package's __init__ rebinds ``repro.core.sweep`` to the function
jsweep = importlib.import_module("repro.core.sweep")
ROOT = Path(__file__).resolve().parents[1]
REL = 1e-6
STEPS, LR = 20, 0.02


def _jax_tool(name: str):
    """The JAX script as a module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_adam():
    return JAdamW(lr=jconstant(LR), weight_decay=0.0, clip_norm=1.0,
                  master_weights=False)


def _jax_loop(loss_of, params, steps, clip):
    """The JAX tools' loop: the loss of every iterate, the final last."""
    grad_fn = jax.jit(jax.value_and_grad(loss_of))
    opt = _jax_adam()
    state = opt.init(params)
    history = []
    for _ in range(steps):
        l, g = grad_fn(params)
        history.append(float(l))
        params, state, _ = opt.update(g, state, params)
        params = clip(params)
    history.append(float(jax.jit(loss_of)(params)))
    return history


def test_tools_share_the_jax_scripts_constants():
    jc, jt = _jax_tool("calibrate_cache"), _jax_tool("calibrate_traffic")
    assert calibrate_cache.FIELDS == jc.FIELDS
    assert calibrate_cache.TARGETS == jc.TARGETS
    assert calibrate_cache.WEIGHTS == jc.WEIGHTS
    assert calibrate_cache.TUNABLE == jc.TUNABLE
    assert calibrate_cache.BOUNDS == jc.BOUNDS
    assert calibrate_traffic.KNOBS == jt.KNOBS
    assert calibrate_traffic.BOUNDS == jt.BOUNDS


def test_calibrate_cache_follows_the_jax_tool():
    """20 steps at lr 0.02 from the frozen CAL: per-step losses within REL
    (the loss climbs from 0.140 to 0.287 as the tuned points move, so the
    selections flip in both the same way), the same best step (the
    start), and the best CAL the start's."""
    jc = _jax_tool("calibrate_cache")
    loss = jsweep.make_calibration_loss(jc.TARGETS, jc.WEIGHTS, jc.FIELDS)
    params = {k: jnp.asarray(math.log(jc.CAL[k]), jnp.float32)
              for k in jc.TUNABLE}
    want = _jax_loop(lambda p: loss(jc._to_cal(p)), params, STEPS, jc._clip)
    cal, best_loss, history = calibrate_cache.calibrate(STEPS, LR, "cpu",
                                                        log=None)
    assert len(history) == STEPS + 1
    np.testing.assert_allclose(history, want, rtol=REL)
    assert history.index(best_loss) == int(np.argmin(want))
    assert best_loss == min(history) <= history[0]
    assert cal.keys() == jc.CAL.keys()
    if history.index(best_loss) == 0:
        for k, v in jc.CAL.items():
            assert cal[k] == pytest.approx(v, rel=REL), k


def _forward_mode_grad(jloss_of, p):
    """``jax.jacfwd`` of the JAX claim loss in the log knobs, or a central
    difference of it (relative step 1e-3) where the forward mode is NaN
    (the two DRAM fractions), as ``test_torch_nvm.py`` holds the port's
    gradient."""
    fwd = jax.jacfwd(jloss_of)(p)
    out = {}
    for k, v in p.items():
        g = float(fwd[k])
        if not np.isfinite(g):
            h = 1e-3 * abs(float(v))
            g = (float(jloss_of({**p, k: v + h}))
                 - float(jloss_of({**p, k: v - h}))) / (2 * h)
        out[k] = jnp.float32(g)
    return out


def test_calibrate_traffic_first_update_follows_forward_mode():
    jt = _jax_tool("calibrate_traffic")
    jloss, _ = jtraffic.make_claim_loss()

    def jloss_of(p):
        return jloss({k: jnp.exp(v) for k, v in p.items()})

    p0 = {k: jnp.asarray(math.log(jt.TRAFFIC[k]), jnp.float32)
          for k in jt.KNOBS}
    opt = _jax_adam()
    want, _, _ = opt.update(_forward_mode_grad(jloss_of, p0), opt.init(p0),
                            p0)
    want = jt._clip(want)
    loss, _ = traffic.make_claim_loss(device="cpu")
    params = {k: torch.tensor(float(v)) for k, v in p0.items()}
    adam_fit(lambda p: loss({k: torch.exp(v) for k, v in p.items()}),
             params, 1, LR, calibrate_traffic.BOUNDS, log=None)
    for k in jt.KNOBS:
        assert float(params[k]) == pytest.approx(float(want[k]), rel=REL), k
        assert float(params[k]) != float(p0[k]), k


def test_calibrate_traffic_ends_at_or_below_the_frozen_loss():
    """20 steps: the best-seen knobs' JAX loss is at most the frozen
    TRAFFIC's JAX loss, and the port's history starts at the frozen
    loss."""
    t, best_loss, history = calibrate_traffic.calibrate(STEPS, LR, "cpu",
                                                        log=None)
    jloss, _ = jtraffic.make_claim_loss()
    frozen = float(jloss({k: jnp.float32(v)
                          for k, v in jtraffic.TRAFFIC.items()}))
    assert history[0] == pytest.approx(frozen, rel=REL)
    assert len(history) == STEPS + 1 and best_loss == min(history)
    assert float(jloss({k: jnp.float32(v) for k, v in t.items()})) <= frozen


@pytest.mark.parametrize("tool", ["calibrate_cache", "calibrate_traffic"])
def test_tool_mains_print_their_fits(tool, capsys):
    mod = {"calibrate_cache": calibrate_cache,
           "calibrate_traffic": calibrate_traffic}[tool]
    assert mod.main(["--steps", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("start loss ") and "final loss " in out
    assert "best step " in out
    if tool == "calibrate_cache":
        assert "CAL = {" in out and out.count("MB rl=") == 5
    else:
        assert "TRAFFIC = {" in out and "R/W: {" in out
        assert out.count("target=") == 13


def test_adam_fit_keeps_the_best_seen_iterate():
    """The best iterate is a copy (not the tensor the loop updates), a
    bound holds after each update, and the final iterate is compared
    last."""
    params = {"a": torch.tensor(0.0), "b": torch.tensor(0.0)}
    best, best_loss, history = adam_fit(
        lambda p: (p["a"] - 1.0) ** 2 + (p["b"] + 1.0) ** 2 + 1.0,
        params, 30, 0.1, {"b": (1.0, 2.0)}, log=None)
    assert float(params["b"]) == 0.0          # clamped to log(1) each step
    assert float(params["a"]) > 0.5           # a moved towards 1
    assert best_loss == min(history) < history[0] and len(history) == 31
    assert best["a"] is not params["a"]
    best, best_loss, history = adam_fit(
        lambda p: -(p["a"] - 0.5) ** 2, {"a": torch.tensor(1.0)}, 5, 0.1,
        {}, log=None)
    assert history.index(best_loss) == 5     # every move lowers it
