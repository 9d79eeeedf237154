"""The port's paged serve path against the JAX package's, on the CPU.

``PagePool``/``RadixTree`` (``repro_torch.serve.paged``) against
``repro.serve.paged`` on the same operations; the paged decode kernel's
plain versions against the Pallas kernel (interpret mode) and
``ref.paged_decode_attention_ref``; the paged suffix attention and the
model's paged decode step against the JAX model; and ``PagedEngine``
greedy outputs and counters against the JAX ``PagedEngine`` (its ``xla``
gather path) and ``EngineReference`` on the workloads of
``tests/test_paged_cache.py``, at ``reduced(llama3-8b, float32)``, max_len
48, 3 slots, page size 8, with the JAX package's weights.
"""
import copy
import io
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattention
from repro.models import build_model as jbuild_model
from repro.serve import EngineReference as JEngineReference
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.serve import ShedPolicy as JShedPolicy
from repro.serve import mixed_requests as jmixed_requests
from repro.serve import paged as jpaged
from repro.serve import run_staggered as jrun_staggered
from repro.serve import shared_prefix_requests as jshared_prefix_requests
from repro.serve import staggered_groups as jstaggered_groups
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (DONE, SHED, PagedEngine, PagePool,
                               PagePoolExhausted, RadixTree, Request,
                               ShedPolicy, mixed_requests, pages_for,
                               run_staggered, shared_prefix_requests,
                               staggered_groups)
from repro_torch.serve import paged as tpaged

MAX_LEN = 48
SLOTS = 3
PS = 8
NB = MAX_LEN // PS
TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py bounds

# the workloads of tests/test_paged_cache.py:209-280, as (generator kwargs,
# arrival group size); each is built by both packages' generators
MIXED = dict(kind="mixed", n=8, seed=11, prompt_lens=(2, 12), max_new=(2, 9))
SHARED = dict(kind="shared", n=9, seed=4, num_templates=2, template_len=26,
              suffix_lens=(2, 6), max_new=(2, 8))
TIGHT = dict(kind="shared", n=8, seed=5, num_templates=2, template_len=26,
             suffix_lens=(2, 6), max_new=(2, 8))
EVICT = dict(kind="mixed", n=10, seed=2, prompt_lens=(9, 14), max_new=(2, 4))


def _reqs(w, jax_side=False):
    kw = {k: v for k, v in w.items() if k != "kind"}
    n = kw.pop("n")
    if w["kind"] == "mixed":
        gen = jmixed_requests if jax_side else mixed_requests
    else:
        gen = jshared_prefix_requests if jax_side else shared_prefix_requests
    return gen(n, vocab=512, **kw)


def _eos_exiting_early(outputs):
    """A token that first occurs at index >= 1 of some output and is no
    output's first token: the eos run then ends that request at a length
    above 1 and ends no request at its first token."""
    firsts = {o[0] for o in outputs.values()}
    for o in outputs.values():
        for t in o[1:]:
            if t not in firsts:
                return t
    raise AssertionError("no early-exit eos token in this workload")


@pytest.fixture(scope="module")
def mp():
    jcfg = jreduced(jget_config("llama3-8b"), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


def _jref(mp, w, group, eos_id=None):
    jmodel, jparams, _, _ = mp
    eng = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                           eos_id=eos_id)
    return jrun_staggered(eng, jstaggered_groups(_reqs(w, True), group))


def _jpaged(mp, w, group, eos_id=None, **kw):
    """JAX PagedEngine (xla gather path): outputs and paged_stats."""
    jmodel, jparams, _, _ = mp
    eng = JPagedEngine(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                       page_size=PS, eos_id=eos_id, record_traffic=False,
                       attn_impl="xla", **kw)
    out = jrun_staggered(eng, jstaggered_groups(_reqs(w, True), group))
    return out, eng.paged_stats()


def _paged(mp, eos_id=None, **kw):
    _, _, model, params = mp
    return PagedEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                       page_size=PS, eos_id=eos_id, device="cpu", **kw)


def _same_stats(port: dict, jax_stats: dict) -> None:
    assert port == {k: jax_stats[k] for k in port}, (port, jax_stats)


# --- PagePool / RadixTree against repro.serve.paged ------------------------


def _drive(mod, seed: int):
    """A seeded engine-like run of pool and tree operations: prompts from
    three templates with private suffixes are matched, pinned, evicted
    for, allocated, inserted and released, while a few stay live.  Returns
    the log of every result and the final pool and tree state."""
    rng = np.random.default_rng(seed)
    pool = mod.PagePool(12, 4)
    tree = mod.RadixTree(pool)
    templates = [list(rng.integers(1, 50, size=n)) for n in (9, 6, 13)]
    live, log = [], []
    for _ in range(60):
        prompt = [int(t) for t in templates[rng.integers(0, 3)]
                  + list(rng.integers(1, 50, size=rng.integers(1, 6)))]
        m, shared = tree.match(prompt[:-1])
        for p in shared:
            pool.share(p)
        need = mod.pages_for(len(prompt) + int(rng.integers(0, 6)), 4) \
            - len(shared)
        evicted = tree.evict(need) if pool.free_pages < need else 0
        try:
            new = pool.alloc(need)
        except mod.PagePoolExhausted as e:
            log.append(("short", m, e.requested, e.free, evicted))
            for p in shared:
                pool.release(p)
            continue
        pages = shared + new
        created = tree.insert(prompt, pages[:mod.pages_for(len(prompt), 4)])
        log.append((m, tuple(shared), tuple(new), evicted, created))
        live.append(pages)
        if len(live) > 2 or rng.random() < 0.4:
            for p in live.pop(int(rng.integers(0, len(live)))):
                pool.release(p)
        held = tree.held_refs()
        for pages_ in live:
            held.update(pages_)
        pool.check(held)
    return log, pool.refcount.tolist(), pool.hwm, list(pool._free), \
        sorted(tree.held_refs().items()), tree.num_nodes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_and_tree_match_jax_on_a_seeded_run(seed):
    got = _drive(tpaged, seed)
    assert got == _drive(jpaged, seed)
    assert any(e[0] == "short" for e in got[0])          # pressure hit
    assert any(e[3] > 0 for e in got[0])                 # evictions ran
    assert any(e[0] not in ("short", 0) for e in got[0])  # prefix hits


def test_pool_alloc_release_cycle_and_errors():
    for mod in (tpaged, jpaged):
        pool = mod.PagePool(4, 8)
        a = pool.alloc(3)
        assert sorted(a) == [0, 1, 2] and pool.free_pages == 1
        with pytest.raises(mod.PagePoolExhausted, match="requested 2.*1 "
                           "free"):
            pool.alloc(2)
        pool.share(a[0])
        pool.release(a[0])
        assert pool.free_pages == 1
        for p in a:
            pool.release(p)
        assert pool.free_pages == 4 and pool.hwm == 3
        with pytest.raises(ValueError, match="dead page"):
            pool.release(a[0])
        pool.check()
    assert issubclass(PagePoolExhausted, RuntimeError)
    assert [pages_for(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]


def test_tree_match_insert_cow_boundary_coverage():
    """The case of tests/test_paged_cache.py:80, on both packages: a
    mid-edge match covers its boundary page (which the engine copies), a
    divergence after a full page shares exactly that page."""
    results = []
    for mod in (tpaged, jpaged):
        pool = mod.PagePool(16, 4)
        tree = mod.RadixTree(pool)
        pages = pool.alloc(3)
        tree.insert([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], pages)
        for p in pages:
            pool.release(p)
        res = [tree.match([1, 2, 3, 4, 5, 6]),
               tree.match([1, 2, 3, 4, 99, 98]), tree.match([42])]
        assert res == [(6, pages[:2]), (4, pages[:1]), (0, [])]
        pool.check(tree.held_refs())
        tree.clear()
        pool.check()
        assert pool.free_pages == 16
        results.append(res)
    assert results[0] == results[1]
    assert isinstance(RadixTree(PagePool(2, 2)), RadixTree)


# --- the paged kernel's plain versions against the Pallas kernel ------------


def _pair(a: np.ndarray, dtype: str):
    return (jnp.asarray(a, jnp.float32).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy().view(np.int32)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _paged_setup(seed, dtype, B=4, nb=5, ps=8, K=2, G=2, hd=16):
    """Pools with a TRASH page, rows 1.. sharing row 0's first two pages,
    every boundary page private (pos >= 2 * ps), ragged positions."""
    rng = np.random.default_rng(seed)
    P = B * nb + 1
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, K * G, hd), (P, ps, K, hd), (P, ps, K, hd), (B, K, hd),
             (B, K, hd))]
    pt = np.arange(B * nb, dtype=np.int32).reshape(B, nb)
    pt[1:, :2] = pt[0, :2]
    pos = np.array([2 * ps, 2 * ps + 3, nb * ps - 1, 3 * ps + 5][:B],
                   np.int32)
    return [_pair(a, dtype) for a in arrs], pt, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (11, 0.0), (0, 50.0),
                                        (11, 50.0)])
def test_paged_attention_matches_jax(dtype, window, cap):
    """Fused: output within the JAX tests' bound of the Pallas kernel
    (interpret mode), pools bitwise equal to the kernel's write-back.
    Unfused, on the written pools: within bound of the Pallas kernel and
    of ``paged_decode_attention_ref``."""
    pairs, pt, pos = _paged_setup(7, dtype)
    (jq, tq), (jk, tk), (jv, tv), (jnk, tnk), (jnv, tnv) = pairs
    jo, jck, jcv = jops.paged_decode_attention_fused(
        jq, jk, jv, jnk, jnv, jnp.asarray(pt), jnp.asarray(pos),
        jnp.int32(window), logit_cap=cap, interpret=True)
    tpt, tpos = torch.from_numpy(pt), torch.from_numpy(pos)
    to = ops.paged_decode_attention_fused(tq, tk, tv, tnk, tnv, tpt, tpos,
                                          window, logit_cap=cap)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_bits(tk), _bits(jck))
    np.testing.assert_array_equal(_bits(tv), _bits(jcv))
    got = ops.paged_decode_attention(tq, tk, tv, tpt, tpos, window,
                                     logit_cap=cap)
    for want in (jops.paged_decode_attention(
                     jq, jck, jcv, jnp.asarray(pt), jnp.asarray(pos),
                     jnp.int32(window), logit_cap=cap, interpret=True),
                 jref.paged_decode_attention_ref(
                     jq, jck, jcv, jnp.asarray(pt), jnp.asarray(pos), window,
                     logit_cap=cap)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,K,G,window,cap", [(96, 2, 2, 0, 0.0),
                                               (96, 1, 4, 11, 30.0),
                                               (16, 4, 1, 11, 50.0)])
def test_paged_attention_matches_jax_at_config_head_dims(dtype, hd, K, G,
                                                         window, cap):
    """phi3-mini-3.8b's head_dim 96 and the reduced configs' 16: the fused
    plain version within the JAX tests' bound of the Pallas kernel
    (interpret mode) and of ``paged_decode_attention_ref``, pools bitwise
    equal to the kernel's write-back."""
    pairs, pt, pos = _paged_setup(21, dtype, K=K, G=G, hd=hd)
    (jq, tq), (jk, tk), (jv, tv), (jnk, tnk), (jnv, tnv) = pairs
    jo, jck, jcv = jops.paged_decode_attention_fused(
        jq, jk, jv, jnk, jnv, jnp.asarray(pt), jnp.asarray(pos),
        jnp.int32(window), logit_cap=cap, interpret=True)
    to = ops.paged_decode_attention_fused(tq, tk, tv, tnk, tnv,
                                          torch.from_numpy(pt),
                                          torch.from_numpy(pos), window,
                                          logit_cap=cap)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_bits(tk), _bits(jck))
    np.testing.assert_array_equal(_bits(tv), _bits(jcv))
    want = jref.paged_decode_attention_ref(jq, jck, jcv, jnp.asarray(pt),
                                           jnp.asarray(pos), window,
                                           logit_cap=cap)
    np.testing.assert_allclose(_f32(to), _f32(want), rtol=tol, atol=tol)


def test_fused_write_touches_only_boundary_rows():
    pairs, pt, pos = _paged_setup(8, "float32")
    (_, q), (_, k), (_, v), (_, nk), (_, nv) = pairs
    k0, v0 = k.clone(), v.clone()
    ops.paged_decode_attention_fused(q, k, v, nk, nv, torch.from_numpy(pt),
                                     torch.from_numpy(pos), 0)
    changed = (k != k0).any(-1).any(-1) | (v != v0).any(-1).any(-1)
    expect = torch.zeros_like(changed)
    for b, p in enumerate(pos.tolist()):
        page, row = pt[b, p // PS], p % PS
        expect[page, row] = True
        assert torch.equal(k[page, row], nk[b])
        assert torch.equal(v[page, row], nv[b])
    assert torch.equal(changed, expect)


def test_position_past_the_table_writes_nothing_as_pallas():
    """pos[b] // ps >= nb: no write (the Pallas index map never visits the
    page), and the row attends every key of its table."""
    pairs, pt, _ = _paged_setup(9, "float32")
    (jq, tq), (jk, tk), (jv, tv), (jnk, tnk), (jnv, tnv) = pairs
    pos = np.array([5 * PS, 17, 5 * PS + 3, 30], np.int32)
    jo, jck, jcv = jops.paged_decode_attention_fused(
        jq, jk, jv, jnk, jnv, jnp.asarray(pt), jnp.asarray(pos),
        jnp.int32(0), interpret=True)
    k0 = tk.clone()
    to = ops.paged_decode_attention_fused(tq, tk, tv, tnk, tnv,
                                          torch.from_numpy(pt),
                                          torch.from_numpy(pos), 0)
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(_bits(tk), _bits(jck))
    np.testing.assert_array_equal(_bits(tv), _bits(jcv))
    assert torch.equal(tk[pt[0]], k0[pt[0]])


def test_pages_beyond_pos_are_ignored():
    """Garbage in pages past a row's depth cannot leak (the JAX test at
    tests/test_paged_cache.py:149)."""
    pairs, pt, pos = _paged_setup(10, "float32")
    (_, q), (_, k), (_, v), _, _ = pairs
    tpt, tpos = torch.from_numpy(pt), torch.from_numpy(pos)
    base = ops.paged_decode_attention(q, k, v, tpt, tpos, 0)
    k2, v2 = k.clone(), v.clone()
    for b, p in enumerate(pos.tolist()):
        k2[pt[b, p // PS + 1:]] = 1e9
        v2[pt[b, p // PS + 1:]] = 1e9
        k2[pt[b, p // PS], p % PS + 1:] = 1e9
        v2[pt[b, p // PS], p % PS + 1:] = 1e9
    poisoned = ops.paged_decode_attention(q, k2, v2, tpt, tpos, 0)
    assert torch.equal(base, poisoned)


@pytest.mark.parametrize("change,match", [
    (dict(hd=48), "head_dim"),
    (dict(pt_dtype=torch.int64), "page_table"),
    (dict(pt_rows=3), "page_table"),
    (dict(pos_dtype=torch.int64), "pos must be"),
    (dict(window=np.int32(2)), "python int"),
    (dict(H=6), "does not fit"),
])
def test_paged_kernel_argument_checks(change, match):
    """What the CUDA wrapper refuses before it would launch."""
    a = dict(B=2, H=4, K=2, P=5, ps=4, nb=2, hd=32, pt_dtype=torch.int32,
             pt_rows=2, pos_dtype=torch.int32, window=0)
    a.update(change)
    q = torch.zeros(a["B"], a["H"], a["hd"])
    k = torch.zeros(a["P"], a["ps"], 4 if a["H"] == 6 else a["K"], a["hd"])
    pt = torch.zeros(a["pt_rows"], a["nb"], dtype=a["pt_dtype"])
    pos = torch.zeros(a["B"], dtype=a["pos_dtype"])
    with pytest.raises(ValueError, match=match):
        pa.check_args(q, k, k, None, None, pt, pos, a["window"])


# --- model layer -------------------------------------------------------------


@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 0.0), (4, 30.0)])
def test_paged_suffix_attention_matches_jax(window, cap):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((3, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    v = rng.standard_normal((3, 24, 2, 16)).astype(np.float32)
    q_pos = (np.array([0, 7, 17])[:, None] + np.arange(6)).astype(np.int32)
    got = attention.paged_suffix_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_pos=torch.from_numpy(q_pos), window=window, logit_cap=cap)
    want = jattention.paged_suffix_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_pos=jnp.asarray(q_pos), window=window, logit_cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def _pools(jmodel, rng, num_pages):
    return {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            for k, v in jmodel.init_paged_cache(num_pages, PS).items()}


def _record_rows(monkeypatch):
    """Record the K/V rows each attention layer hands to the pool write
    (the port's own projections), as [k0, v0, k1, v1, ...] of (B, S, K,
    hd), on the plain scatter and on the fused kernel op alike."""
    rec = []
    write_rows, fused = attention.write_rows, ops.paged_decode_attention_fused

    def recording_write(pool, rows, *a, **kw):
        rec.append(rows.to(pool.dtype).clone())
        return write_rows(pool, rows, *a, **kw)

    def recording_fused(q, k, v, new_k, new_v, *a, **kw):
        rec.extend([new_k[:, None].clone(), new_v[:, None].clone()])
        return fused(q, k, v, new_k, new_v, *a, **kw)

    monkeypatch.setattr(attention, "write_rows", recording_write)
    monkeypatch.setattr(ops, "paged_decode_attention_fused", recording_fused)
    return rec


def _check_pools(tc, jc, before, written, rec):
    """Rows written this step, ``written`` as (b, s, page, row): bitwise
    the port's own projections ``rec`` and within 1e-5 of JAX (each
    framework computes K/V with its own matmuls); every other row outside
    TRASH bitwise as it was and as JAX left it."""
    for i, n in enumerate(("k", "v")):
        t, j = tc[n].numpy(), np.asarray(jc[n])
        np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)
        assert len(rec) == 2 * t.shape[0]
        for layer in range(t.shape[0]):
            own = rec[2 * layer + i].numpy()
            for b, s, page, row in written:
                np.testing.assert_array_equal(t[layer, page, row],
                                              own[b, s])
        keep = np.ones(t.shape[:3], bool)
        keep[:, -1] = False                            # TRASH
        for _, _, page, row in written:
            keep[:, page, row] = False
        np.testing.assert_array_equal(t[keep], before[n][keep])
        np.testing.assert_array_equal(j[keep], before[n][keep])


@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_paged_decode_step_matches_jax(mp, impl, monkeypatch):
    """One paged decode tick: logits within 1e-4 of the JAX step; each
    row's own K/V lands bitwise in its boundary page and no other pool row
    changes."""
    jmodel, jparams, model, params = mp
    rng = np.random.default_rng(5)
    P = 3 * NB + 1
    pools = _pools(jmodel, rng, P)
    pt = np.arange(3 * NB, dtype=np.int32).reshape(3, NB)
    pt[1, :2] = pt[0, :2]                              # shared prefix
    pos = np.array([3, 21, 47], np.int32)
    toks = np.array([[7], [11], [13]], np.int32)
    jl, jc = jmodel.decode_step(
        jparams, {k: jnp.asarray(v) for k, v in pools.items()},
        {"tokens": jnp.asarray(toks)}, jnp.asarray(pos),
        attn_impl="xla", page_table=jnp.asarray(pt))
    tc = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    rec = _record_rows(monkeypatch)
    tl, tc2 = model.decode_step(
        params, tc, {"tokens": torch.from_numpy(toks)}, torch.from_numpy(pos),
        attn_impl=impl, page_table=torch.from_numpy(pt))
    assert tc2 is tc
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _check_pools(tc, jc, pools, [(b, 0, pt[b, p // PS], p % PS)
                                 for b, p in enumerate(pos.tolist())], rec)


def test_paged_suffix_prefill_step_matches_jax(mp, monkeypatch):
    """The suffix prefill (S > 1 tokens per row from each row's matched
    prefix, padding masked to TRASH): logits within 1e-4 of JAX, the
    suffix rows within 1e-5 of JAX and bitwise the port's own K/V, every
    other row bitwise; ``logits_at`` picks the rows' last suffix tokens."""
    jmodel, jparams, model, params = mp
    rng = np.random.default_rng(6)
    P = 3 * NB + 1
    pools = _pools(jmodel, rng, P)
    pt = np.arange(3 * NB, dtype=np.int32).reshape(3, NB)
    pt[2, :2] = pt[0, 3:5]          # a shared prefix that no row writes
    starts = np.array([0, 13, 20], np.int32)
    lens = np.array([8, 3, 5])
    S = 8
    toks = rng.integers(1, 512, (3, S)).astype(np.int32)
    mask = np.arange(S)[None, :] < lens[:, None]
    jl, jc = jmodel.decode_step(
        jparams, {k: jnp.asarray(v) for k, v in pools.items()},
        {"tokens": jnp.asarray(toks)}, jnp.asarray(starts),
        attn_impl="xla", page_table=jnp.asarray(pt),
        kv_write_mask=jnp.asarray(mask))
    tc = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    rec = _record_rows(monkeypatch)
    tl, _ = model.decode_step(
        params, tc, {"tokens": torch.from_numpy(toks)},
        torch.from_numpy(starts), page_table=torch.from_numpy(pt),
        kv_write_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    _check_pools(tc, jc, pools, [
        (b, i, pt[b, (s + i) // PS], (s + i) % PS)
        for b, s in enumerate(starts.tolist()) for i in range(lens[b])], rec)
    monkeypatch.undo()
    tc = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    at, _ = model.decode_step(
        params, tc, {"tokens": torch.from_numpy(toks)},
        torch.from_numpy(starts), page_table=torch.from_numpy(pt),
        kv_write_mask=torch.from_numpy(mask),
        logits_at=torch.from_numpy(lens - 1))
    np.testing.assert_allclose(at[:, 0].numpy(),
                               tl[torch.arange(3), lens - 1].numpy(),
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="paged branch"):
        model.decode_step(params, model.init_cache(3, MAX_LEN),
                          {"tokens": torch.from_numpy(toks)},
                          torch.from_numpy(starts))
    with pytest.raises(ValueError, match="suffix prefill"):
        model.decode_step(params, tc, {"tokens": torch.from_numpy(toks)},
                          torch.from_numpy(starts), attn_impl="kernel",
                          page_table=torch.from_numpy(pt))


# --- PagedEngine against the JAX engines -------------------------------------


@pytest.fixture(scope="module")
def mixed_ref(mp):
    """JAX EngineReference on the mixed workload, eos-free, the early-exit
    eos drawn from it, and the outputs with that eos."""
    free = _jref(mp, MIXED, 2)
    eos = _eos_exiting_early(free)
    return free, eos, _jref(mp, MIXED, 2, eos_id=eos)


def test_eos_workload_exercises_an_early_exit(mixed_ref):
    """The precondition of the eos parity runs, on its own: the chosen eos
    ends some request at a length above 1 and is no output's first token
    (the JAX suite's probe can break this, ROADMAP Queue C)."""
    free, eos, with_eos = mixed_ref
    assert any(o[-1] == eos and len(o) > 1 for o in with_eos.values())
    assert all(o[0] != eos for o in free.values())
    assert with_eos != free


@pytest.fixture(scope="module")
def mixed_jpaged(mp, mixed_ref):
    _, eos, _ = mixed_ref
    return {K: _jpaged(mp, MIXED, 2, eos_id=eos, ticks_per_sync=K)
            for K in (1, 4)}


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_paged_engine_mixed_staggered_eos_matches_jax(mp, mixed_ref,
                                                      mixed_jpaged, K, impl):
    """Staggered arrivals, uneven lengths, an eos exit: the port's
    PagedEngine emits the JAX EngineReference's and PagedEngine's tokens,
    with the JAX PagedEngine's counters."""
    _, eos, with_eos = mixed_ref
    jout, jstats = mixed_jpaged[K]
    assert jout == with_eos
    eng = _paged(mp, eos_id=eos, ticks_per_sync=K, attn_impl=impl,
                 sample_impl=impl)
    assert run_staggered(eng, staggered_groups(_reqs(MIXED), 2)) == with_eos
    _same_stats(eng.paged_stats(), jstats)
    eng.pool.check(eng.tree.held_refs())   # all slots free: tree refs only


@pytest.mark.parametrize("w,group,kw,check", [
    (SHARED, SLOTS, dict(ticks_per_sync=4),
     lambda st: st["cow_copies"] > 0 and st["prefix_tokens"] > 0),
    (TIGHT, SLOTS, dict(ticks_per_sync=2, num_pages=2 * NB + 2),
     lambda st: st["deferred"] > 0 and st["pages_hwm"] <= 2 * NB + 2),
    (EVICT, 1, dict(ticks_per_sync=2, num_pages=2 * NB),
     lambda st: st["evicted_pages"] > 0),
], ids=["shared_prefix_cow", "tight_pool_defers", "eviction"])
def test_paged_engine_workloads_match_jax(mp, w, group, kw, check):
    """Shared-prefix copy-on-write, a pool tight enough to defer, and
    distinct prompts that force LRU eviction: outputs equal the JAX
    EngineReference's and PagedEngine's, counters the latter's."""
    want = _jref(mp, w, group)
    jout, jstats = _jpaged(mp, w, group, **kw)
    assert jout == want
    eng = _paged(mp, **kw)
    assert run_staggered(eng, staggered_groups(_reqs(w), group)) == want
    st = eng.paged_stats()
    assert check(st)
    _same_stats(st, jstats)
    eng.pool.check(eng.tree.held_refs())


def test_cow_owner_keeps_decoding_into_boundary_page(mp):
    """A long-running owner writes decode KV into its boundary page after
    the tree registered it; a sharer copies that page.  The sharer's
    output equals its solo reference run (tests/test_paged_cache.py)."""
    jmodel, jparams, _, _ = mp
    template = list(range(100, 126))                  # 26 % 8 != 0
    a = Request(uid=0, prompt=template + [7, 9], max_new_tokens=14)
    b = Request(uid=1, prompt=template + [3, 5], max_new_tokens=6)
    jref_eng = JEngineReference(jmodel, jparams, slots=SLOTS,
                                max_len=MAX_LEN)
    solo = jrun_staggered(jref_eng, [[JRequest(uid=1, prompt=b.prompt,
                                               max_new_tokens=6)]])
    eng = _paged(mp, ticks_per_sync=2)
    eng.submit(copy.deepcopy(a))
    eng.step()                                        # owner decoding
    got = run_staggered(eng, [[copy.deepcopy(b)]])
    assert got[1] == solo[1]
    assert eng.paged_stats()["cow_copies"] >= 1
    eng.run()
    eng.pool.check(eng.tree.held_refs())


def test_shed_after_max_defers_matches_jax(mp):
    """A pool too tight for the arrival wave with ``max_defers=0``: the
    requests the JAX engine sheds are shed here, the rest match."""
    jmodel, jparams, _, _ = mp
    kw = dict(slots=SLOTS, max_len=MAX_LEN, page_size=PS, num_pages=NB,
              ticks_per_sync=2)
    jeng = JPagedEngine(jmodel, jparams, record_traffic=False,
                        shed_policy=JShedPolicy(max_defers=0), **kw)
    jreqs = _reqs(TIGHT, True)
    for r in jreqs:
        jeng.submit(r)
    jeng.run()
    _, _, model, params = mp
    eng = PagedEngine(model, params, shed_policy=ShedPolicy(max_defers=0),
                      device="cpu", **kw)
    reqs = _reqs(TIGHT)
    for r in reqs:
        eng.submit(r)
    assert eng.run() == 0
    assert [r.state for r in reqs] == [r.state for r in jreqs]
    assert SHED in {r.state for r in reqs} and DONE in {r.state
                                                        for r in reqs}
    assert all(r.reason for r in reqs if r.state == SHED)
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    _same_stats(eng.paged_stats(), jeng.paged_stats())
    eng.pool.check(eng.tree.held_refs())


def test_every_freed_slot_returns_its_pages(mp):
    """Slots freed at prefill (one new token), by decode, and by a
    quarantine all go through ``_release_slot``: the slot's page
    references return and its table row maps TRASH, uploaded before the
    next window.  The quarantine also flushes the tree, zeroes every free
    page and requeues the request."""
    eng = _paged(mp, ticks_per_sync=2)
    one = Request(uid=0, prompt=[5, 6, 7], max_new_tokens=1)
    two = Request(uid=1, prompt=list(range(1, 20)), max_new_tokens=6)
    eng.submit(one)
    eng.submit(two)
    eng._admit()
    assert one.state == DONE and eng.slot_req[0] is None
    assert (eng._pt_host[0] == eng.trash).all() and eng._pt_dirty
    held = eng.tree.held_refs()
    held.update(eng._slot_pages[1])
    eng.pool.check(held)
    eng._pre_window()
    assert torch.equal(eng._pt_dev, torch.from_numpy(eng._pt_host))
    eng._quarantine({1: 0}, 0.0)
    assert eng.slot_req[1] is None and eng._slot_pages[1] == []
    assert (eng._pt_host[1] == eng.trash).all() and eng._pt_dirty
    assert eng.tree.num_nodes == 0 and eng.pool.free_pages == eng.num_pages
    eng.pool.check(eng.tree.held_refs())
    for pool in eng.cache.values():
        assert not pool[:, :eng.num_pages].any()
    assert list(eng._queue) == [two] and two.retries == 1
    rs = eng.resilience_stats()
    assert rs["quarantined"] == rs["retried"] == 1 and rs["failed"] == 0
    assert eng.paged_stats()["tree_flushes"] == 1


def test_paged_engine_validation(mp):
    _, _, model, params = mp
    with pytest.raises(ValueError, match="multiple of page_size"):
        PagedEngine(model, params, slots=2, max_len=50, page_size=8,
                    device="cpu")
    with pytest.raises(ValueError, match="full-length"):
        PagedEngine(model, params, slots=2, max_len=48, page_size=8,
                    num_pages=3, device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        PagedEngine(model, params, slots=2, max_len=48, page_size=8,
                    attn_impl="xla", device="cpu")
    eng = PagedEngine(model, params, slots=2, max_len=48, device="cpu")
    assert eng.num_pages == 2 * NB and eng.cache["k"].shape[1] == 2 * NB + 1


def test_shared_prefix_requests_match_jax():
    for kw in (dict(), dict(num_templates=2, template_len=26,
                            temperature=0.5, temperature_every=3)):
        a = shared_prefix_requests(7, seed=3, **kw)
        b = jshared_prefix_requests(7, seed=3, **kw)
        assert [(r.prompt, r.max_new_tokens, r.temperature) for r in a] == \
            [(r.prompt, r.max_new_tokens, r.temperature) for r in b]


def test_launcher_serves_shared_prefix_paged_on_cpu():
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--paged", "--shared-prefix",
                           "--requests", "8", "--slots", "4",
                           "--max-len", "64", "--ticks-per-sync", "4"])
    text = buf.getvalue()
    assert "served 8 requests" in text and "DONE=8" in text
    line = next(x for x in text.splitlines() if x.startswith("paged KV"))
    cow = int(line.split("CoW copies ")[1].split(",")[0])
    hits = int(line.split("(")[2].split("/")[0])
    assert cow > 0 and hits > 0
    with pytest.raises(SystemExit):
        launch_serve.main(["--device", "cpu", "--shared-prefix"])
