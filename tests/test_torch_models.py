"""The port's dense decoder (``repro_torch.models``) against the JAX
package's, on the CPU, with the same weights: ``model.init(PRNGKey(0))``
of the JAX package passed through ``params_from_numpy``.

Prefill logits and per-row-position decode logits agree within atol/rtol
1e-4, the bound ``tests/test_serve_engine.py`` holds the JAX decode path
to.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.models import common as jcommon
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.models import (UnsupportedFamilyError, attention, build_model,
                                common)
from repro_torch.models.convert import params_from_numpy

MAX_LEN = 48
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("llama3-8b"), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


def test_configs_are_the_jax_packages():
    for arch in list_archs():
        assert get_config(arch).__dict__ == jget_config(arch).__dict__
    assert reduced(get_config("llama3-8b"), dtype="float32").__dict__ == \
        jreduced(jget_config("llama3-8b"), dtype="float32").__dict__


def test_param_names_and_shapes_match_jax(models):
    jmodel, jparams, model, params = models
    assert set(params) == set(jparams)
    for name, p in params.items():
        assert tuple(p.shape) == jparams[name].shape, name
        np.testing.assert_array_equal(p.numpy(), np.asarray(jparams[name]))


def test_prefill_matches_jax(models):
    jmodel, jparams, model, params = models
    toks = np.random.default_rng(0).integers(0, 512, (3, 11)).astype(
        np.int32)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)},
                            attn_impl="naive")
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-4, rtol=1e-4)
    # unembedding only the taken rows gives those rows' logits
    at = torch.tensor([10, 0, 4])
    tl_at, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                             logits_at=at)
    np.testing.assert_allclose(tl_at[:, 0].numpy(),
                               tl[torch.arange(3), at].numpy(), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_vector_position_decode_matches_jax(models, impl):
    """One decode step at per-row positions: logits within 1e-4 of the JAX
    decode step; each row's K/V lands at its own position and no other
    cache row changes."""
    jmodel, jparams, model, params = models
    rng = np.random.default_rng(1)
    cache = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
             for k, v in jmodel.init_cache(3, 16).items()}
    pos = np.array([2, 5, 15], np.int32)
    toks = np.array([[7], [11], [13]], np.int32)
    jl, jc = jmodel.decode_step(
        jparams, {k: jnp.asarray(v) for k, v in cache.items()},
        {"tokens": jnp.asarray(toks)}, jnp.asarray(pos))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, tc2 = model.decode_step(params, tc, {"tokens": torch.from_numpy(toks)},
                                torch.from_numpy(pos), attn_impl=impl)
    assert tc2 is tc                               # updated in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5, rtol=1e-5)
        keep = np.ones(cache[n].shape[:3], bool)
        keep[:, np.arange(3), pos] = False
        np.testing.assert_array_equal(tc[n].numpy()[keep], cache[n][keep])


def test_rms_norm_and_rope_match_jax():
    """(1 + gamma) RMSNorm and half-split f32 RoPE at llama3-8b's theta."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    g = (rng.standard_normal(64) * 0.1).astype(np.float32)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g))),
        atol=1e-6, rtol=1e-6)
    xr = rng.standard_normal((2, 5, 4, 128)).astype(np.float32)
    positions = np.array([[0, 1, 511, 777, 1023]] * 2, np.int32)
    np.testing.assert_allclose(
        common.rope(torch.from_numpy(xr), torch.from_numpy(positions),
                    500000.0).numpy(),
        np.asarray(jcommon.rope(jnp.asarray(xr), jnp.asarray(positions),
                                500000.0)), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (3, 0.0), (4, 30.0)])
def test_attention_paths_match_jax(window, cap):
    """Prefill attention and the model-level decode attention against
    their JAX counterparts, with local windows and logit softcaps."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        attention.naive_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window,
                                  logit_cap=cap).numpy(),
        np.asarray(jattention.naive_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
            logit_cap=cap)), atol=2e-5, rtol=2e-5)
    pos = np.array([0, 6], np.int32)
    np.testing.assert_allclose(
        attention.decode_attention(
            torch.from_numpy(q[:, :1]), torch.from_numpy(k),
            torch.from_numpy(v), pos=torch.from_numpy(pos), window=window,
            logit_cap=cap).numpy(),
        np.asarray(jattention.decode_attention(
            jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
            pos=jnp.asarray(pos), window=window, logit_cap=cap)),
        atol=2e-5, rtol=2e-5)


def test_bf16_weights_cross_the_bridge_bitwise():
    jcfg = jreduced(jget_config("llama3-8b"))               # bfloat16
    jparams = jbuild_model(jcfg, max_seq=16).init(jax.random.PRNGKey(1))
    cfg = reduced(get_config("llama3-8b"))
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    w = "blocks/attn/wq"
    assert params[w].dtype == torch.bfloat16
    np.testing.assert_array_equal(params[w].view(torch.int16).numpy(),
                                  np.asarray(jparams[w]).view(np.int16))


def test_bridge_rejects_wrong_names_and_shapes(models):
    jmodel, jparams, model, params = models
    flat = {k: np.asarray(v) for k, v in jparams.items()}
    cfg = model.cfg
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(cfg, {k: v for k, v in flat.items()
                                if k != "emb/tok"}, device="cpu")
    bad = dict(flat, **{"final_ln/g": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(cfg, bad, device="cpu")


def test_init_follows_the_jax_init_rules(models):
    """Same names, shapes, dtypes and init kinds as the JAX package's
    ``materialize``: zeros for norms, fan-in scaled normals elsewhere;
    reproducible from the generator's seed."""
    _, jparams, model, _ = models
    a = model.init(torch.Generator().manual_seed(0))
    b = model.init(torch.Generator().manual_seed(0))
    assert set(a) == set(jparams)
    for name, p in a.items():
        assert torch.equal(p, b[name])
        assert p.dtype == torch.float32 and tuple(p.shape) == \
            jparams[name].shape
    assert not a["final_ln/g"].any() and not a["blocks/ln1/g"].any()
    wq = a["blocks/attn/wq"]                      # (L, D, H, hd)
    fan_in = wq.shape[0] * wq.shape[1] * wq.shape[2]
    assert abs(float(wq.std()) * fan_in ** 0.5 - 1.0) < 0.05
    assert abs(float(a["emb/tok"].std()) / 0.02 - 1.0) < 0.05


def test_entry_points_default_to_cuda_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(cfg, {})
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_other_families_raise_unsupported():
    with pytest.raises(UnsupportedFamilyError, match="'encdec'") as ei:
        build_model(reduced(get_config("whisper-tiny")), device="cpu")
    assert ei.value.family == "encdec"
    assert ei.value.supported == ("dense", "hybrid", "moe", "ssm", "vlm")
    assert isinstance(ei.value, ValueError)


def test_port_imports_no_jax_and_nothing_of_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits
