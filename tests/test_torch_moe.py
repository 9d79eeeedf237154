"""The port's moe and vlm families (``repro_torch.models.moe``, the moe
and vlm paths of ``models/transformer.py`` and ``models/api.py``) against
the JAX package's, on the CPU, with the same weights (``model.init`` of
the JAX package through ``models/convert.py``) and numpy-seeded inputs.

``moe_block`` is held to ``repro.models.moe.moe_block`` at capacity
factors that drop assignments and that drop none: y within the f32
kernel bound of ``tests/test_kernels.py`` (rtol 2e-5, atol 1e-6), the aux
loss within rel 1e-6, and the dispatch metadata (each assignment's slot
and keep flag, put in the JAX stable sort's order) and the gathered
expert buffer bit for bit, read from the JAX ``one_group`` through a spy
on ``jax.vmap`` (a ``jax.debug.callback`` after the dispatch, so that
compiled programs report too).  Prefill and decode logits
agree within the 1e-4 the dense model tests use.

The engines are held to their own JAX classes, token for token: a
prefill that drops gives ``Engine`` other tokens than ``EngineReference``
(which prefills one token at a time and never drops) in the JAX package
as well.  That the prompts drop real tokens is asserted on its own, from
the JAX side: the JAX engines run under the spy, and each prefill's keep
flags are read against its prompt lengths.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.models import build_model as jbuild_model
from repro.models import moe as jmoe
from repro.models.api import input_specs as jinput_specs
from repro.models.common import materialize as jmaterialize
from repro.serve import Engine as JEngine
from repro.serve import EngineReference as JEngineReference
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import mixed_requests as jmixed_requests
from repro.serve import run_staggered as jrun_staggered
from repro.serve import shared_prefix_requests as jshared_prefix_requests
from repro.serve import staggered_groups as jstaggered_groups
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.launch import graph_analysis as ga
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model, moe
from repro_torch.models import transformer as tf
from repro_torch.models.api import input_specs, make_inputs
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (DONE, Engine, EngineReference, PagedEngine,
                               mixed_requests, run_staggered,
                               shared_prefix_requests, staggered_groups)

MAX_LEN = 64
SLOTS = 3
GRANITE = "granite-moe-3b-a800m"
MOONSHOT = "moonshot-v1-16b-a3b"
INTERNVL = "internvl2-26b"
# overrides of reduced(): moonshot with 16 experts keeps its expert count
# a multiple of 16 (the unpadded branch); reduced granite pads 8 to 16
OVERRIDES = {GRANITE: {}, MOONSHOT: {"num_experts": 16}, INTERNVL: {}}
# mixed requests whose prompts pad to 32 tokens (capacity 16 at top-2 of
# 8 experts): long enough that real tokens drop, and (seed 9) that a drop
# changes a greedy token of the JAX Engine against its EngineReference
MIXED = dict(n=6, seed=9, prompt_lens=(20, 32), max_new=(2, 8))
SHARED = dict(n=6, seed=4, num_templates=2, template_len=26,
              suffix_lens=(2, 6), max_new=(2, 8))


def _cfgs(arch, **kw):
    kw = {**OVERRIDES[arch], "dtype": "float32", **kw}
    return jreduced(jget_config(arch), **kw), reduced(get_config(arch), **kw)


_PAIRS = {}


def _pair(arch):
    """(jmodel, jparams, model, params) of reduced ``arch`` at f32, the
    port's weights the JAX package's."""
    if arch not in _PAIRS:
        jcfg, cfg = _cfgs(arch)
        jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
        jparams = jmodel.init(jax.random.PRNGKey(0))
        model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
        params = params_from_numpy(
            cfg, {k: np.asarray(v) for k, v in jparams.items()},
            device="cpu")
        _PAIRS[arch] = (jmodel, jparams, model, params)
    return _PAIRS[arch]


@contextlib.contextmanager
def _jax_dispatches():
    """Collect (buffer, dest, t_s, keep) of every JAX ``one_group``
    dispatch traced inside the block: the spy on ``jax.vmap`` adds a
    ``jax.debug.callback`` after the batched dispatch, so an eager call
    reports at once and a program compiled inside the block (a JAX
    engine's prefill or window) reports each time it runs."""
    got = []
    vmap = jax.vmap

    def keep_meta(*meta):
        got.append(tuple(np.asarray(m) for m in meta))

    def spy(f, *a, **k):
        g = vmap(f, *a, **k)
        if getattr(f, "__name__", "") != "one_group":
            return g

        def run(*args):
            out = g(*args)
            dest, t_s, _, keep = out[1]
            jax.debug.callback(keep_meta, out[0], dest, t_s, keep)
            return out
        return run

    jax.vmap = spy
    try:
        yield got
    finally:
        jax.vmap = vmap


# --- moe_block against repro.models.moe ---------------------------------------


def test_capacity_padding_and_param_defs_match_jax():
    for arch in (GRANITE, MOONSHOT):
        for kw in ({}, OVERRIDES[arch]):
            jcfg, cfg = _cfgs(arch, **kw)
            assert moe.padded_experts(cfg) == jmoe.padded_experts(jcfg)
            for S in (1, 7, 8, 32, 512, 1024):
                for cf in (0.5, 1.25, 8.0):
                    assert moe.capacity(dataclasses.replace(
                        cfg, moe_capacity_factor=cf), S) == jmoe.capacity(
                        dataclasses.replace(jcfg, moe_capacity_factor=cf),
                        S)
            jdefs, defs = jmoe.moe_param_defs(jcfg), moe.moe_param_defs(cfg)
            assert {n: (d.shape, d.scale) for n, d in defs.items()} == \
                {n: (d.shape, d.scale) for n, d in jdefs.items()}
    full = get_config(GRANITE)
    assert moe.padded_experts(full) == 48
    assert moe.padded_experts(get_config(MOONSHOT)) == 64


def _block_case(case, cf):
    """(jcfg, cfg, JAX params, port params, x (3, 64, D)) of one case."""
    arch = MOONSHOT if case == "moonshot16" else GRANITE
    jcfg, cfg = _cfgs(arch, moe_capacity_factor=cf)
    jp = jmaterialize(jmoe.moe_param_defs(jcfg), jax.random.PRNGKey(7),
                      "float32")
    if case == "tie":
        # experts 3 and 5 share a router column: every token ties them
        jp["router"] = jp["router"].at[:, 5].set(jp["router"][:, 3])
    x = np.random.default_rng(11).standard_normal(
        (3, 64, cfg.d_model)).astype(np.float32)
    tp = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jp.items()}
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("case", ["granite", "moonshot16", "tie"])
def test_moe_block_matches_jax(case, cf):
    jcfg, cfg, jp, tp, x = _block_case(case, cf)
    with _jax_dispatches() as got:
        jy, jaux = jmoe.moe_block(jcfg, jp, jnp.asarray(x))
    (jbuf, jdest, _, jkeep), = got
    xt = torch.from_numpy(x)
    y, aux = moe.moe_block(cfg, tp, xt)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=1e-6)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    probs, gates, idx = moe.route(cfg, tp["router"], xt)
    B, C, Ep = 3, moe.capacity(cfg, 64), moe.padded_experts(cfg)
    d = moe.dispatch(cfg, idx, C)
    # JAX's metadata is in its stable sort's order, its slots e*C + rank
    order = torch.argsort(idx.reshape(B, -1), dim=-1, stable=True)
    dest = torch.where(d.keep, d.slot // (B * C) * C + d.slot % C, Ep * C)
    np.testing.assert_array_equal(dest.gather(1, order).numpy(),
                                  np.asarray(jdest))
    np.testing.assert_array_equal(d.keep.gather(1, order).numpy(),
                                  np.asarray(jkeep))
    buf = moe._gather_slots(cfg, xt, d, C).view(Ep, B, C, -1)
    np.testing.assert_array_equal(
        buf.transpose(0, 1).reshape(B, Ep * C, -1).numpy(),
        np.asarray(jbuf))
    drops = int((~d.keep).sum())
    assert drops > 0 if cf == 0.5 else (cf < 8.0 or drops == 0), drops
    if case == "tie":
        assert torch.equal(probs[..., 3], probs[..., 5])
        both = (idx == 3).any(-1) & (idx == 5).any(-1)
        assert both.any()             # the tie decided inside the top k
        first = idx[..., 0]
        assert not bool((first == 5).any())    # lower index first


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_identity_experts_preserve_scale(seed):
    """Mirror of ``tests/test_properties.py``'s
    ``test_moe_identity_experts_preserve_scale``: with every expert the
    same map and no drops, rerouting changes nothing."""
    _, cfg = _cfgs(GRANITE, moe_capacity_factor=8.0)
    gen = torch.Generator().manual_seed(seed)
    from repro_torch.models.common import materialize
    p = materialize(moe.moe_param_defs(cfg), gen, "float32",
                    torch.device("cpu"))
    x = torch.randn((2, 16, cfg.d_model), generator=gen)
    for k in ("w_up", "w_gate", "w_down"):
        p[k] = p[k][:1].expand_as(p[k]).contiguous()
    y1, _ = moe.moe_block(cfg, p, x)
    y2, _ = moe.moe_block(cfg, dict(p, router=-p["router"]), x)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-2, atol=2e-3)


def test_dummy_experts_are_never_routed_to_and_drops_are_tallied():
    """Granite's padded experts (8 -> 16 reduced) receive no assignment;
    ``tally_drops`` counts what ``dispatch`` drops, with no tally nothing
    is collected."""
    _, cfg, _, tp, x = _block_case("granite", 0.5)
    probs, gates, idx = moe.route(cfg, tp["router"], torch.from_numpy(x))
    assert int(idx.max()) < cfg.num_experts
    C = moe.capacity(cfg, 64)
    with moe.tally_drops() as tally:
        d = moe.dispatch(cfg, idx, C)
    assert moe.dropped(tally) == (int((~d.keep).sum()), d.keep.numel())
    assert moe.dropped(tally)[0] > 0
    assert not moe._tallies
    filled = d.tokmap < 3 * 64
    per_expert = filled.view(moe.padded_experts(cfg), 3 * C).sum(-1)
    assert int(per_expert[cfg.num_experts:].sum()) == 0
    assert int(filled.sum()) == int(d.keep.sum())


# --- model level --------------------------------------------------------------


def _vision(jmodel, B):
    cfg = jmodel.cfg
    return np.random.default_rng(5).standard_normal(
        (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", [GRANITE, MOONSHOT, INTERNVL])
def test_prefill_matches_jax(arch):
    jmodel, jparams, model, params = _pair(arch)
    toks = np.random.default_rng(0).integers(0, 512, (3, 40)).astype(
        np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if arch == INTERNVL:
        ve = _vision(jmodel, 3)
        jb["vision_embeds"] = jnp.asarray(ve)
        tb["vision_embeds"] = torch.from_numpy(ve)
    jl, jc = jmodel.prefill(jparams, jb, attn_impl="naive")
    tl, tc = model.prefill(params, tb)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-4, rtol=1e-4)
    if arch == INTERNVL:
        # the vision embeddings reach the logits
        tl0, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)})
        assert not np.allclose(tl0.numpy()[:, :8], tl.numpy()[:, :8])
        with pytest.raises(ValueError, match="vision embeddings"):
            model.prefill(params, {"tokens": tb["tokens"][:, :4],
                                   "vision_embeds": tb["vision_embeds"]})


@pytest.mark.parametrize("impl", ["plain", "kernel"])
@pytest.mark.parametrize("arch", [GRANITE, MOONSHOT, INTERNVL])
def test_vector_position_decode_matches_jax(arch, impl):
    jmodel, jparams, model, params = _pair(arch)
    rng = np.random.default_rng(1)
    cache = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
             for k, v in jmodel.init_cache(3, 16).items()}
    pos = np.array([2, 5, 15], np.int32)
    toks = np.array([[7], [11], [13]], np.int32)
    jl, jc = jmodel.decode_step(
        jparams, {k: jnp.asarray(v) for k, v in cache.items()},
        {"tokens": jnp.asarray(toks)}, jnp.asarray(pos))
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tl, _ = model.decode_step(params, tc, {"tokens": torch.from_numpy(toks)},
                              torch.from_numpy(pos), attn_impl=impl)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=1e-5, rtol=1e-5)


def test_train_mode_forward_carries_the_aux_loss():
    """The decoder's train mode sums every MoE layer's aux loss, as JAX's
    ``forward`` does; ``Model.loss`` adds it to a finite cross-entropy."""
    jmodel, jparams, model, params = _pair(GRANITE)
    toks = np.random.default_rng(2).integers(0, 512, (2, 32)).astype(
        np.int32)
    jl, _, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                                 mode="train", attn_impl="naive")
    tl, cache, aux = tf.decoder_forward(model.cfg, params,
                                        torch.from_numpy(toks), mode="train")
    assert cache is None
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-4, rtol=1e-4)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    assert float(aux) > 0
    dense = build_model(reduced(get_config("llama3-8b"), dtype="float32"),
                        max_seq=MAX_LEN, device="cpu")
    dp = dense.init(torch.Generator().manual_seed(0))
    assert dense.forward(dp, {"tokens": torch.from_numpy(toks)},
                         mode="train")[2] is None
    loss = model.loss(params, {"tokens": torch.from_numpy(toks),
                               "labels": torch.from_numpy(toks)})
    assert bool(torch.isfinite(loss)) and float(loss) > float(aux)


# --- engines ------------------------------------------------------------------


def _workload(kind, jax_side=False, vocab=512):
    kw = dict(MIXED if kind == "mixed" else SHARED)
    n = kw.pop("n")
    if kind == "mixed":
        gen = jmixed_requests if jax_side else mixed_requests
    else:
        gen = jshared_prefix_requests if jax_side else shared_prefix_requests
    return gen(n, vocab=vocab, **kw)


def _record_prefills(jeng, paged: bool):
    """Record (padded length, lens, admit) of each prefill program the JAX
    engine runs (lens: each row's prompt or unshared suffix length)."""
    calls = []
    jit = jeng._prefill_jit

    def rec(*args):
        calls.append((args[3].shape[1],
                      np.asarray(args[6] if paged else args[4]),
                      np.asarray(args[8] if paged else args[5])))
        return jit(*args)

    jeng._prefill_jit = rec
    return calls


def _real_drops(calls, meta, layers: int, K: int) -> int:
    """Assignments of admitted rows' real (not padding) tokens that the
    recorded prefills dropped, from the JAX dispatches' own keep flags
    (``meta`` in run order; a decode tick's and a one-token prefill's are
    K wide, and cannot drop: C >= 8 >= K)."""
    wide = [m for m in meta if m[2].shape[1] > K]
    calls = [c for c in calls if c[0] > 1]
    assert len(wide) == layers * len(calls)
    n = 0
    for i, (S, lens, admit) in enumerate(calls):
        for _, _, t_s, keep in wide[i * layers:(i + 1) * layers]:
            assert t_s.shape[1] == S * K
            real = (t_s < lens[:, None]) & admit[:, None]
            n += int((~keep & real).sum())
    return n


_JAX_RUNS = {}


def _jax_run(arch, engine, kind):
    """Outputs of a JAX engine class on a workload (memoised), and the
    real-token drops of its prefills (None for EngineReference and
    without a router)."""
    key = (arch, engine, kind)
    if key not in _JAX_RUNS:
        jmodel, jparams, _, _ = _pair(arch)
        kw = dict(slots=SLOTS, max_len=MAX_LEN)
        if engine == "ref":
            jeng = JEngineReference(jmodel, jparams, **kw)
        elif engine == "paged":
            jeng = JPagedEngine(jmodel, jparams, page_size=8,
                                record_traffic=False, attn_impl="xla",
                                ticks_per_sync=4, **kw)
        else:
            jeng = JEngine(jmodel, jparams, record_traffic=False,
                           ticks_per_sync=4, **kw)
        counted = engine != "ref" and jmodel.cfg.is_moe
        calls = _record_prefills(jeng, engine == "paged") if counted \
            else None
        with (_jax_dispatches() if counted
              else contextlib.nullcontext()) as meta:
            out = jrun_staggered(jeng, jstaggered_groups(
                _workload(kind, jax_side=True), SLOTS))
        drops = None if calls is None else _real_drops(
            calls, meta, jmodel.cfg.num_layers, jmodel.cfg.top_k)
        _JAX_RUNS[key] = (out, drops)
    return _JAX_RUNS[key]


def test_the_jax_engines_drop_real_tokens_in_prefill():
    """The precondition of the engine tests below: the workloads' prefills
    drop real tokens in the JAX engines, so ``Engine`` and
    ``EngineReference`` differ there (and each port engine is held to its
    own JAX class)."""
    out, drops = _jax_run(GRANITE, "engine", "mixed")
    ref, _ = _jax_run(GRANITE, "ref", "mixed")
    assert drops > 0
    assert out != ref
    _, pdrops = _jax_run(GRANITE, "paged", "shared")
    assert pdrops > 0


@pytest.mark.parametrize("K", [1, 4])
def test_engine_matches_the_jax_engine(K):
    want, _ = _jax_run(GRANITE, "engine", "mixed")
    _, _, model, params = _pair(GRANITE)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=K, device="cpu")
    reqs = _workload("mixed")
    assert run_staggered(eng, staggered_groups(reqs, SLOTS)) == want
    assert all(r.state == DONE for r in reqs)


def test_engine_reference_matches_the_jax_reference():
    want, _ = _jax_run(GRANITE, "ref", "mixed")
    _, _, model, params = _pair(GRANITE)
    ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                          device="cpu")
    assert run_staggered(ref, staggered_groups(_workload("mixed"),
                                               SLOTS)) == want


def test_paged_engine_matches_the_jax_paged_engine():
    want, _ = _jax_run(GRANITE, "paged", "shared")
    _, _, model, params = _pair(GRANITE)
    eng = PagedEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                      page_size=8, ticks_per_sync=4, device="cpu")
    assert run_staggered(eng, staggered_groups(_workload("shared"),
                                               SLOTS)) == want
    st = eng.paged_stats()
    assert st["prefix_tokens"] > 0 and st["cow_copies"] > 0
    eng.pool.check(eng.tree.held_refs())


def test_vlm_engine_matches_the_jax_engine():
    """internvl2 serves on tokens alone, as the JAX engines do."""
    want, _ = _jax_run(INTERNVL, "engine", "mixed")
    _, _, model, params = _pair(INTERNVL)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=4, device="cpu")
    assert run_staggered(eng, staggered_groups(_workload("mixed"),
                                               SLOTS)) == want


def test_serve_records_name_the_family():
    _, _, model, params = _pair(GRANITE)
    for cls, kw in ((Engine, {}), (PagedEngine, {"page_size": 8})):
        eng = cls(model, params, slots=SLOTS, max_len=MAX_LEN,
                  ticks_per_sync=2, device="cpu", **kw)
        run_staggered(eng, staggered_groups(_workload("mixed")[:3], SLOTS))
        recs = eng.serve_records()
        assert {r["kind"] for r in recs} == {"decode", "prefill"}
        assert all(r["family"] == "moe" and "read_fraction" not in r
                   for r in recs)
        assert all(r["shape"].startswith("serve_moe_") for r in recs)
        calls = eng._traffic["decode"].kernel_calls
        attn = ("paged_decode_attention" if cls is PagedEngine
                else "decode_attention")
        assert calls == {attn: model.cfg.num_layers * 2, "fused_sample": 2}


# --- builds, refusals, specs, the counter -------------------------------------


def test_build_model_takes_moe_and_vlm_and_training_refuses_them(capsys):
    """Both families build and serve on both engines (every family
    trains: ``tests/test_torch_train_moe.py``, and whisper's
    ``tests/test_torch_train_encdec.py``); whisper-tiny builds too, and
    serves on the dense engines alone."""
    for arch in (GRANITE, MOONSHOT, INTERNVL):
        cfg = get_config(arch)
        model = build_model(reduced(cfg), device="cpu")
        assert model.serve_modes == frozenset({"dense", "paged"})
    whisper = build_model(reduced(get_config("whisper-tiny")), device="cpu")
    assert whisper.serve_modes == frozenset({"dense"})
    launch_serve.main(["--list-configs"])
    listing = capsys.readouterr().out
    for arch, fam in ((GRANITE, "moe"), (MOONSHOT, "moe"),
                      (INTERNVL, "vlm")):
        assert f"{arch:<22} {fam:<8} Engine, EngineReference, PagedEngine" \
            in listing


@pytest.mark.parametrize("arch", [GRANITE, INTERNVL, "llama3-8b"])
def test_input_specs_match_jax(arch):
    for name, shape in SHAPES.items():
        got = input_specs(get_config(arch), shape)
        want = jinput_specs(jget_config(arch), JSHAPES[name])
        assert list(got) == list(want)
        for n, (shp, dt) in got.items():
            assert shp == want[n].shape
            assert str(dt).split(".")[-1] == want[n].dtype.name
    cfg = reduced(get_config(arch))
    small = dataclasses.replace(SHAPES["train_4k"], seq_len=16,
                                global_batch=2)
    a = make_inputs(cfg, small, torch.Generator().manual_seed(3),
                    device="cpu")
    b = make_inputs(cfg, small, torch.Generator().manual_seed(3),
                    device="cpu")
    assert set(a) == set(input_specs(cfg, small))
    for n, t in a.items():
        assert torch.equal(t, b[n])
        assert tuple(t.shape) == input_specs(cfg, small)[n][0]
    assert 0 <= int(a["tokens"].min()) and \
        int(a["tokens"].max()) < cfg.vocab_size


def test_op_counter_counts_the_dispatch_ops_by_the_walker_rule():
    """The dispatch's ops (stable sort, gather, scatter and scatter-add,
    cumsum, index_add_, index) count their distinct operands plus their
    outputs, as the walker counts a sort, gather or scatter."""
    e = torch.tensor([[3, 1, 3, 0, 2, 1]])
    t = torch.arange(6)[None]
    f32 = torch.zeros(4)
    cases = [
        (lambda: torch.argsort(e, dim=-1, stable=True),
         e.numel() * 8 * 3, "sort"),
        (lambda: torch.gather(e, 1, t), 3 * 6 * 8, "gather"),
        (lambda: torch.zeros((1, 4), dtype=torch.int64).scatter_add_(
            1, e, torch.ones_like(e)), None, "scatter_add_"),
        (lambda: torch.cumsum(e, 1), 2 * 6 * 8, "cumsum"),
        (lambda: f32.index_add_(0, torch.tensor([1, 1, 2]),
                                torch.ones(3)), None, "index_add_"),
    ]
    for fn, want, name in cases:
        with ga.OpCounter() as c:
            fn()
        assert name in c.stats.bytes_by_op, (name, c.stats.bytes_by_op)
        if want is not None:
            assert c.stats.bytes_by_op[name] == want, name
    with ga.OpCounter() as c:
        torch.zeros((1, 4), dtype=torch.int64).scatter_add_(
            1, e, torch.ones_like(e))
    # self (operand and output), index, src
    assert c.stats.bytes_by_op["scatter_add_"] == (4 * 2 + 6 + 6) * 8
    with ga.OpCounter() as c:
        f32.index_add_(0, torch.tensor([1, 1, 2]), torch.ones(3))
    assert c.stats.bytes_by_op["index_add_"] == 4 * 2 * 4 + 3 * 8 + 3 * 4
    assert c.stats.flops == 0
