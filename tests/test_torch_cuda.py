"""The port's CUDA kernels against their plain versions, a train step on the
flash kernel against the plain path, and the paged
engine and the recurrent families' engine on their kernels against
``EngineReference``, on the card.

Marked ``cuda``; each test skips with a reason where no CUDA device is
present (the fixture decides, at run time).  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed.
"""
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sampling as sm  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# The bf16 flash kernel beyond the JAX bound, as ``chip_smoke.py`` holds
# it (limits from readings of sound runs, PERF.md): each row's relative L2
# error of o against the plain output before its bf16 rounding, and the
# relative Frobenius error of the ``FlashAttention`` gradients against f32
# autograd of the plain version.  Its lse is held to f32's 1e-5.
FLASH_BF16_ROW_REL = 8e-3
FLASH_BF16_GRAD_REL = 5e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,L,hd,window,cap", [
    (4, 8, 2, 128, 64, 0, 0.0),
    (3, 4, 4, 96, 32, 0, 0.0),
    (2, 8, 1, 128, 128, 24, 0.0),
    (5, 6, 2, 64, 256, 8, 50.0),
    (4, 4, 2, 64, 16, 0, 0.0),         # reduced() configs' head_dim
    (3, 8, 2, 700, 16, 40, 30.0),
    (4, 32, 32, 300, 96, 0, 0.0),      # phi3-mini-3.8b's heads
    (2, 6, 3, 1000, 96, 100, 50.0),
])
def test_decode_attention_kernel_matches_plain(dev, dtype, B, H, K, L, hd,
                                               window, cap):
    g = torch.Generator(device=dev).manual_seed(0)
    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, k, v, nk, nv = (r(B, H, hd), r(B, L, K, hd), r(B, L, K, hd),
                       r(B, K, hd), r(B, K, hd))
    pos = torch.randint(0, L, (B,), generator=g, device=dev,
                        dtype=torch.int32)
    pos[0] = 0
    kp, vp = k.clone(), v.clone()
    want = da.decode_attention_fused_plain(q, kp, vp, nk, nv, pos, window,
                                           logit_cap=cap)
    before = ops.launches["decode_attention"]
    got = ops.decode_attention_fused(q, k, v, nk, nv, pos, window,
                                     logit_cap=cap)
    torch.cuda.synchronize()
    assert ops.launches["decode_attention"] == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(k, kp) and torch.equal(v, vp)
    unfused = ops.decode_attention(q, k, v, pos, window, logit_cap=cap)
    torch.testing.assert_close(unfused.float(), want.float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,window,pos", [
    (8, 1024, 0, [0, 1, 127, 128, 300, 511, 777, 1023]),   # the smoke's
    (1, 1000, 0, [999]),            # B = 1, L not a multiple of the chunk
    (3, 1000, 0, [0, 5, 64]),       # pos = 0, rows inside one chunk
    (4, 1000, 200, [999, 640, 199, 450]),   # the window kills chunks
    (2, 100, 0, [99, 40]),          # one chunk a row, a cluster of one
])
def test_decode_attention_split_edge_cases(dev, dtype, B, L, window, pos):
    """The split-K kernel on rows that leave blocks of a cluster without a
    live key, fill one chunk or less, or start past whole chunks: within
    the bound of the plain version, the write-back bitwise, only (b,
    pos[b]) changed."""
    H, K, hd = 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(7)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, k, v, nk, nv = (r(B, H, hd), r(B, L, K, hd), r(B, L, K, hd),
                       r(B, K, hd), r(B, K, hd))
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    k0, v0 = k.clone(), v.clone()
    kp, vp = k.clone(), v.clone()
    want = da.decode_attention_fused_plain(q, kp, vp, nk, nv, p, window)
    got = ops.decode_attention_fused(q, k, v, nk, nv, p, window)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(k, kp) and torch.equal(v, vp)
    changed = (k != k0).any(dim=(2, 3)) | (v != v0).any(dim=(2, 3))
    allowed = torch.zeros_like(changed)
    allowed[torch.arange(B, device=dev), p.long()] = True
    assert not bool((changed & ~allowed).any())
    assert bool(torch.isfinite(got.float()).all())


@pytest.mark.parametrize("B,V", [(6, 128256), (6, 1000), (6, 31),
                                 (1, 128256), (64, 128256)])
def test_fused_sample_kernel_matches_plain(dev, B, V):
    """Greedy rows bitwise torch.argmax, temperature rows the plain
    version's tokens up to last-ulp ties, on rows split over a cluster: a
    tie and a NaN whose occurrences lie in different blocks of a row, rows
    of -inf, a short vocab (a cluster of one) and one or 64 rows."""
    g = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn(B, V, generator=g, device=dev) * 3
    temps = torch.rand(B, generator=g, device=dev) * 2
    temps[::3] = 0.0
    logits[0, [1, V - 1]] = 90.0                       # first-occurrence tie
    temps[0] = 0.0
    if B > 1:
        temps[1] = -1.0
        logits[1, [V // 2, V // 3, V - 2]] = float("nan")  # first NaN wins
        logits[2 % B] = float("-inf")
        logits[B - 1] = float("-inf")                  # at a temperature
        temps[B - 1] = 0.7
    key = torch.tensor([3, 0xFFFFFFFF], dtype=torch.int64, device=dev)
    before = ops.launches["fused_sample"]
    got = ops.fused_sample(logits, temps, key)
    want = sm.fused_sample_plain(logits, temps, key)
    assert ops.launches["fused_sample"] == before + 1
    assert got.dtype == torch.int32 and int(got[0]) == 1
    greedy = temps <= 0
    assert torch.equal(got[greedy],
                       torch.argmax(logits, -1).to(torch.int32)[greedy])
    if B > 1:
        assert int(got[1]) == V // 3 and int(got[B - 1]) == 0
    score = sm.perturbed_logits(logits, temps, key)
    for b in torch.nonzero(got != want).flatten().tolist():
        gap = float(score[b, int(want[b])] - score[b, int(got[b])])
        assert abs(gap) <= 1e-5 * float(score[b].abs().max())


def _zipf(n, footprint, seed, theta=1.3):
    import numpy as np
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.zipf(theta, n) % footprint).astype("int32"))


@pytest.mark.parametrize("nsets,ways,tile,n", [
    (1, 1, 1, 5000), (1, 16, 1, 5000), (8, 1, 8, 6000), (81, 16, 27, 9000),
    (96, 4, 48, 9000), (1536, 16, 256, 20000)])
def test_cache_sim_kernel_matches_plain(dev, nsets, ways, tile, n):
    from repro_torch.kernels import cache_sim as cs
    sid = (_zipf(n, 10 * nsets, nsets + ways) % nsets).to(dev)
    tags = _zipf(n, 700, nsets).to(dev)
    want = cs.cache_sim_plain(sid, tags, num_sets=nsets, ways=ways)
    before = ops.launches["cache_sim"]
    got = ops.cache_sim(sid, tags, num_sets=nsets, ways=ways,
                        sets_tile=tile)
    torch.cuda.synchronize()
    assert ops.launches["cache_sim"] == before + 1
    assert got.tolist() == want.tolist() and int(got.sum()) == n


@pytest.mark.parametrize("ways,num_sets,tile", [
    (4, (1, 3, 7, 20, 33), 8), (1, (1, 2, 5), 4), (16, (1,), 1),
    (16, (16, 23, 32, 64, 96, 128, 256, 512, 1024), 256)])
def test_cache_sim_ladder_kernel_matches_plain(dev, ways, num_sets, tile):
    from repro_torch.kernels import cache_sim as cs
    traces = torch.stack([_zipf(7000, 5000, s) for s in (0, 1, 2)]).to(dev)
    want = cs.cache_sim_ladder_plain(traces, num_sets, ways=ways)
    before = ops.launches["cache_sim_ladder"]
    got = ops.cache_sim_ladder(traces, num_sets=num_sets, ways=ways,
                               sets_tile=tile)
    torch.cuda.synchronize()
    assert ops.launches["cache_sim_ladder"] == before + 1
    assert torch.equal(got, want)
    assert bool((got.sum(2) == traces.shape[1]).all())


def _point_matches_plain(dev, sid, tags, ns, ways, tile=None):
    from repro_torch.kernels import cache_sim as cs
    sid = torch.as_tensor(sid, dtype=torch.int32).to(dev)
    tags = torch.as_tensor(tags, dtype=torch.int32).to(dev)
    want = cs.cache_sim_plain(sid, tags, num_sets=ns, ways=ways)
    got = ops.cache_sim(sid, tags, num_sets=ns, ways=ways, sets_tile=tile)
    torch.cuda.synchronize()
    assert got.tolist() == want.tolist() and int(got.sum()) == sid.numel()
    return got.tolist()


def _ladder_matches_plain(dev, traces, ladder, ways, tile=256):
    from repro_torch.kernels import cache_sim as cs
    traces = torch.as_tensor(traces, dtype=torch.int32).to(dev)
    want = cs.cache_sim_ladder_plain(traces, ladder, ways=ways)
    got = ops.cache_sim_ladder(traces, num_sets=ladder, ways=ways,
                               sets_tile=tile)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got.sum(2) == traces.shape[1]).all())
    return got


@pytest.mark.parametrize("ways", [1, 4, 16])
def test_cache_sim_no_repeats_on_one_set(dev, ways):
    """One set, ``ways + 1`` tags in turn: every access misses and the
    collapse drops none, a chain of T dependent updates."""
    T = 3000
    tags = torch.arange(T) % (ways + 1)
    assert _point_matches_plain(dev, torch.zeros(T), tags, 1, ways) == [0, T]
    got = _ladder_matches_plain(dev, tags.view(1, T) * 7, (1, 7), ways)
    assert got[0, 0].tolist() == [0, T]


@pytest.mark.parametrize("ns", [1, 8, 300])
def test_cache_sim_one_tag_repeated(dev, ns):
    """One line T times: one cold miss, T - 1 hits the collapse takes."""
    T = 5000
    assert _point_matches_plain(dev, torch.zeros(T), torch.full((T,), 3), ns,
                                16) == [T - 1, 1]
    got = _ladder_matches_plain(dev, torch.full((2, T), 12345), (1, ns, 5000),
                                4)
    assert (got[:, :, 0] == T - 1).all() and (got[:, :, 1] == 1).all()


@pytest.mark.parametrize("T", [0, 1, 2, 8191, 8193, 17161, 12345])
def test_cache_sim_trace_lengths(dev, T):
    """Empty, single-access, and lengths that are a multiple of no chunk
    or block size."""
    line = _zipf(T, 5000, T)
    for ns, ways in ((1, 4), (81, 16), (1536, 16)):
        _point_matches_plain(dev, line % ns, line // ns, ns, ways)
    _ladder_matches_plain(dev, torch.stack([line, line.flip(0)]),
                          (1, 16, 96, 1536), 16)


def test_cache_sim_more_than_65536_sets(dev):
    """Set counts of three radix passes, per point and in a ladder with
    rungs of one and two passes; every line twice in a row."""
    import numpy as np
    rng = np.random.RandomState(7)
    line = torch.from_numpy(np.repeat(rng.randint(0, 2 ** 22, 150000),
                                      2).astype("int32"))
    for ns in (65537, 70001, 2 ** 17 + 3):
        _point_matches_plain(dev, line % ns, line // ns, ns, 8)
    _ladder_matches_plain(dev, line.view(1, -1), (200, 4096, 70001), 8)


def test_cache_sim_ladder_rungs_of_one_set_and_of_more_sets_than_accesses(
        dev):
    T = 3000
    traces = torch.stack([_zipf(T, 40000, s) for s in (3, 4)])
    _ladder_matches_plain(dev, traces, (1, 5, T, 3 * T, 10 * T), 16)
    line = traces[0].long()
    _point_matches_plain(dev, line % (3 * T), line // (3 * T), 3 * T, 4,
                         tile=1000)


@pytest.mark.parametrize("W", [1, 5])
def test_cache_sim_ladder_trace_counts(dev, W):
    traces = torch.stack([_zipf(9000, 5000, s) for s in range(W)])
    _ladder_matches_plain(dev, traces, (1, 3, 16, 23, 96, 300), 4, tile=32)


def test_cache_sim_ladder_groups_and_stage_times(dev, monkeypatch):
    """Problems in groups under a small scratch cap (groups that split a
    rung's traces) give the counts of one group; one group's kernels time
    between CUDA events."""
    from repro_torch.kernels import cache_sim as cs
    traces = torch.stack([_zipf(7000, 5000, s) for s in range(5)]).to(dev)
    ladder = (1, 23, 300, 1536)
    whole = _ladder_matches_plain(dev, traces, ladder, 16)
    per_problem = ops._cache_sim_fns("cache_sim_ladder")[1](1, 7000, 1536, 1)
    monkeypatch.setattr(cs, "SCRATCH_CAP", 3 * per_problem)
    got = _ladder_matches_plain(dev, traces, ladder, 16)
    assert torch.equal(got, whole)
    monkeypatch.setattr(cs, "SCRATCH_CAP", 2 ** 32)
    stages = []
    got = cs.launch_ladder_cuda(ops._cache_sim_fns("cache_sim_ladder"),
                                traces, ladder, 16, 256, stage_ms=stages)
    assert torch.equal(got, whole)
    assert len(stages) == len(cs.stage_names(1536)) == 10
    assert all(t > 0 for t in stages)


def test_cache_sim_kernels_refuse_more_than_16_ways(dev):
    x = torch.zeros(2, 64, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="ways"):
        ops.cache_sim_ladder(x, num_sets=(4,), ways=32)
    with pytest.raises(ValueError, match="ways"):
        ops.cache_sim(x[0], x[1], num_sets=4, ways=17, sets_tile=4)


def _paged_inputs(dev, dtype, B, H, K, hd, ps, nb, shared, seed):
    """Pools with a TRASH page (the last), rows 1.. sharing row 0's first
    ``shared`` pages, every boundary page private, ragged positions."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    P = B * nb + 1
    pt = torch.arange(B * nb, dtype=torch.int32, device=dev).view(B, nb)
    pt[1:, :shared] = pt[0, :shared]
    pos = torch.randint(shared * ps, nb * ps, (B,), generator=g,
                        device=dev, dtype=torch.int32)
    pos[-1] = nb * ps - 1
    return (r(B, H, hd), r(P, ps, K, hd), r(P, ps, K, hd), r(B, K, hd),
            r(B, K, hd), pt.contiguous(), pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,hd,ps,nb,shared,window,cap", [
    (8, 32, 8, 128, 8, 128, 64, 0, 0.0),      # chip_smoke's shapes, ps 8
    (8, 32, 8, 128, 16, 64, 32, 11, 50.0),    # ps 16, window, softcap
    (3, 4, 4, 32, 5, 7, 2, 0, 0.0),           # MHA, odd page size
    (2, 8, 1, 256, 4, 9, 3, 6, 30.0),         # MQA, hd 256
    (4, 4, 2, 16, 8, 6, 2, 0, 0.0),           # reduced() configs' hd 16
    (3, 8, 2, 16, 16, 5, 1, 9, 50.0),
    (4, 32, 32, 96, 8, 16, 4, 0, 0.0),        # phi3-mini-3.8b's heads
    (2, 6, 3, 96, 16, 8, 2, 20, 30.0),
])
def test_paged_attention_kernel_matches_plain(dev, dtype, B, H, K, hd, ps,
                                              nb, shared, window, cap):
    from repro_torch.kernels import paged_attention as pa
    q, k, v, nk, nv, pt, pos = _paged_inputs(dev, dtype, B, H, K, hd, ps,
                                             nb, shared, 3)
    kp, vp = k.clone(), v.clone()
    want = pa.paged_decode_attention_fused_plain(q, kp, vp, nk, nv, pt, pos,
                                                 window, logit_cap=cap)
    before = ops.launches["paged_decode_attention"]
    got = ops.paged_decode_attention_fused(q, k, v, nk, nv, pt, pos, window,
                                           logit_cap=cap)
    torch.cuda.synchronize()
    assert ops.launches["paged_decode_attention"] == before + 1
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(k, kp) and torch.equal(v, vp)
    unfused = ops.paged_decode_attention(q, k, v, pt, pos, window,
                                         logit_cap=cap)
    torch.testing.assert_close(unfused.float(), want.float(), atol=tol,
                               rtol=tol)


def _paged_pool(dev, dtype, ps, nb, pos, shared, free, seed, H=32, K=8,
                hd=128):
    """Pools of B * nb pages + TRASH (the last) for rows at ``pos``: the
    second to fourth live rows map the first live row's first ``shared``
    pages, the rows in ``free`` map every page to TRASH."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    B = len(pos)
    P = B * nb + 1
    pt = torch.arange(B * nb, dtype=torch.int32, device=dev).view(B, nb)
    live = [b for b in range(B) if b not in free]
    for b in live[1:4]:
        pt[b, :shared] = pt[live[0], :shared]
    pt[list(free)] = P - 1
    return (r(B, H, hd), r(P, ps, K, hd), r(P, ps, K, hd), r(B, K, hd),
            r(B, K, hd), pt.contiguous(),
            torch.tensor(pos, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ps,nb,pos,shared,free,window", [
    (8, 16, [40, 17, 63, 24, 0, 3, 7, 60], 2, (), 0),    # inside one chunk
    (5, 205, [127, 128, 129, 640, 1024, 300, 999, 5], 20, (), 0),   # ps 5
    (5, 205, [1024, 640, 149, 450, 129, 700, 999, 5], 20, (), 150),
    (8, 128, [1023, 640, 199, 450, 900, 256, 700, 64], 8, (), 200),
    (8, 32, [256, 259, 255, 300, 100, 128, 255, 3], 0, (), 0),  # past nb*ps
    (8, 32, [256, 259, 255, 270, 100, 128, 255, 3], 0, (), 40),
    (8, 128, [512, 513, 640, 1023, 700, 5, 5, 9], 64, (5, 6, 7), 0),
])
def test_paged_attention_split_edge_cases(dev, dtype, ps, nb, pos, shared,
                                          free, window):
    """The split-K paged kernel on rows inside one chunk, chunk boundaries
    inside pages (ps 5), a window that skips whole chunks, rows at and past
    the end of their table (no write, the last key nb*ps - 1), shared
    prefixes and three free slots racing on TRASH: live rows within the
    bound of the plain version, the write-back bitwise outside TRASH, only
    each live row's (pt[b, pos/ps], pos%ps) changed."""
    from repro_torch.kernels import paged_attention as pa
    q, k, v, nk, nv, pt, p = _paged_pool(dev, dtype, ps, nb, pos, shared,
                                         free, 8)
    live = [b for b in range(len(pos)) if b not in free]
    k0, v0 = k.clone(), v.clone()
    kp, vp = k.clone(), v.clone()
    want = pa.paged_decode_attention_fused_plain(q, kp, vp, nk, nv, pt, p,
                                                 window)
    got = ops.paged_decode_attention_fused(q, k, v, nk, nv, pt, p, window)
    torch.cuda.synchronize()
    tol = TOL[dtype]
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=tol, rtol=tol)
    assert bool(torch.isfinite(got[live].float()).all())
    pages = slice(0, k.shape[0] - 1)           # every page but TRASH
    assert torch.equal(k[pages], kp[pages]) and torch.equal(v[pages],
                                                            vp[pages])
    changed = ((k != k0).any(dim=(2, 3)) | (v != v0).any(dim=(2, 3)))[pages]
    allowed = torch.zeros_like(changed)
    for b in live:
        if pos[b] // ps < nb:
            allowed[int(pt[b, pos[b] // ps]), pos[b] % ps] = True
    assert not bool((changed & ~allowed).any())


def test_paged_engine_kernel_matches_reference(dev):
    """PagedEngine on the CUDA paged kernel and sampler against
    EngineReference, greedy, on the shared-prefix workload: the reduced
    llama3-8b (head_dim 16) at float32."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import (EngineReference, PagedEngine,
                                   run_staggered, shared_prefix_requests,
                                   staggered_groups)
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=48, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def reqs():
        return shared_prefix_requests(9, seed=4, num_templates=2,
                                      template_len=26, suffix_lens=(2, 6),
                                      max_new=(2, 8))

    ref = EngineReference(model, params, slots=3, max_len=48, device=dev)
    want = run_staggered(ref, staggered_groups(reqs(), 3))
    before = ops.launches["paged_decode_attention"]
    eng = PagedEngine(model, params, slots=3, max_len=48, page_size=8,
                      ticks_per_sync=4, device=dev)
    assert run_staggered(eng, staggered_groups(reqs(), 3)) == want
    assert ops.launches["paged_decode_attention"] - before == \
        cfg.num_layers * eng.counts["decode_ticks"]
    st = eng.paged_stats()
    assert st["cow_copies"] > 0 and st["prefix_tokens"] > 0
    eng.pool.check(eng.tree.held_refs())


def _ssd_inputs(dev, dtype, b, S, H, P, N, seed, s0=False):
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    dt = torch.nn.functional.softplus(r(b, S, H) - 1.0)
    A = -torch.exp(r(H)) * 0.3
    x, Bm, Cm = r(b, S, H, P), r(b, S, N, scale=0.3), r(b, S, N, scale=0.3)
    state = r(b, H, P, N) if s0 else None
    dt = dt.to(dtype)
    return (x.to(dtype), dt, (dt * A.to(dtype)).contiguous(), Bm.to(dtype),
            Cm.to(dtype), state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,H,P,N,chunk,s0", [
    (2, 512, 4, 64, 128, 256, True),    # mamba2's P, N and chunk
    (1, 64, 2, 16, 8, 16, False),       # tests/test_kernels.py shapes
    (2, 128, 4, 32, 16, 32, True),
    (1, 200, 3, 24, 40, 100, True),     # ragged tiles: Q, P, N off 64
    (2, 11, 2, 32, 16, 11, False),      # a short prefill: one 11-row chunk
    (2, 2048, 4, 64, 128, 256, True),   # 8 chunks: the state passing
    (1, 512, 3, 64, 128, 512, True),    # chunk = S, 8 row tiles a chunk
])
def test_ssd_scan_kernel_matches_plain(dev, dtype, b, S, H, P, N, chunk,
                                       s0):
    """The CUDA SSD kernel against its plain version within the JAX kernel
    test's bounds (f32 5e-4, bf16 5e-2), the final state included."""
    from repro_torch.kernels import ssd_scan as ssd
    args = _ssd_inputs(dev, dtype, b, S, H, P, N, 5, s0)
    want_y, want_s = ssd.ssd_scan_plain(*args[:5], chunk=chunk, s0=args[5])
    before = ops.launches["ssd_scan"]
    got_y, got_s = ops.ssd_scan(*args[:5], chunk=chunk, s0=args[5])
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan"] == before + 1
    assert got_y.dtype == dtype and got_s.dtype == torch.float32
    tol = 5e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got_y.float(), want_y.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(got_s, want_s, atol=tol, rtol=tol)


def test_ssd_scan_kernel_refuses_what_it_does_not_take(dev):
    x, dt, dtA, Bm, Cm, _ = _ssd_inputs(dev, torch.float32, 1, 64, 2, 96,
                                        16, 0)
    with pytest.raises(ValueError, match="P <= 64"):
        ops.ssd_scan(x, dt, dtA, Bm, Cm, chunk=32)
    x, dt, dtA, Bm, Cm, _ = _ssd_inputs(dev, torch.float32, 1, 64, 2, 16,
                                        16, 0)
    with pytest.raises(ValueError, match="must divide"):
        ops.ssd_scan(x, dt, dtA, Bm, Cm, chunk=48)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt,
                     dtA, Bm, Cm, chunk=32)


def test_ssd_scan_stage_times(dev):
    """With ``stage_ms`` the launcher times its five kernels between CUDA
    events and returns what the untimed call returns."""
    from repro_torch.kernels import ssd_scan as ssd
    args = _ssd_inputs(dev, torch.bfloat16, 2, 512, 4, 64, 128, 7, True)
    stage_ms = []
    got = ssd.launch_cuda(ops.ssd_scan_fns(), *args[:5], 256, args[5],
                          stage_ms=stage_ms)
    want = ops.ssd_scan(*args[:5], chunk=256, s0=args[5])
    torch.cuda.synchronize()
    assert len(stage_ms) == len(ssd.STAGE_NAMES) == 5
    assert all(t > 0 for t in stage_ms)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,S,R,h0", [
    (8, 1, 2560, True),      # a recurrentgemma-2b decode tick
    (4, 2048, 2560, True),   # its prefill shape
    (3, 37, 100, False),     # ragged: S off the unroll, R off the block
])
def test_rglru_scan_kernel_equals_plain_bitwise(dev, B, S, R, h0):
    """The kernel rounds the product and the sum separately, as the plain
    version does: outputs and final state equal bit for bit."""
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device=dev).manual_seed(6)
    a = torch.rand(B, S, R, generator=g, device=dev)
    b = torch.randn(B, S, R, generator=g, device=dev) * 0.1
    h = torch.randn(B, R, generator=g, device=dev) if h0 else None
    want = rg.rglru_scan_plain(a, b, h)
    before = ops.launches["rglru_scan"]
    got = ops.rglru_scan(a, b, h)
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan"] == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("R,offset", [(37, 0), (100, 1), (2560, 2)])
def test_rglru_scan_kernel_copy_paths_bitwise(dev, R, offset):
    """The plain entry's narrower copies: rows of 37 floats (4-byte
    cp.async) and inputs that start 4 or 8 bytes past a 16-byte boundary;
    bit for bit with the plain version."""
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device=dev).manual_seed(8)
    B, S = 3, 45
    n = B * S * R
    a = torch.rand(n + offset, generator=g, device=dev)[offset:].view(B, S, R)
    b = (torch.randn(n + offset, generator=g, device=dev) * 0.1)[
        offset:].view(B, S, R)
    h = torch.randn(B, R, generator=g, device=dev)
    want = rg.rglru_scan_plain(a, b, h)
    got = ops.rglru_scan(a, b, h)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _ulps(got, want):
    """Largest distance in f32 ulps (bf16 values compared as f32)."""
    g, w = (t.float().contiguous().view(torch.int32).long() for t in
            (got, want))
    g = torch.where(g < 0, -(g & 0x7FFFFFFF), g)
    w = torch.where(w < 0, -(w & 0x7FFFFFFF), w)
    return int((g - w).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R", [
    (8, 1, 2560),            # a recurrentgemma-2b decode tick
    (4, 2048, 2560),         # its prefill shape
    (3, 37, 100),            # ragged: S off the tile, R off the block
    (2, 70, 37),             # odd rows: 4-byte (f32) and element (bf16) copies
])
def test_rglru_gated_scan_kernel_matches_plain(dev, dtype, B, S, R):
    """The gated entry (gates and recurrence in one launch) against the
    plain composition on the same card, from a nonzero h0: bit for bit."""
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device=dev).manual_seed(9)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = r(B, S, R).to(dtype)
    rr, ii = torch.sigmoid(r(B, S, R)).to(dtype), \
        torch.sigmoid(r(B, S, R)).to(dtype)
    lam = r(R).to(dtype)
    h = r(B, R)
    want = rg.rglru_gated_scan_plain(x, rr, ii, lam, h)
    before = ops.launches["rglru_scan"]
    got = ops.rglru_gated_scan(x, rr, ii, lam, h)
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan"] == before + 1
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert (_ulps(got[0], want[0]), _ulps(got[1], want[1])) == (0, 0)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_recurrent_engine_kernel_matches_reference(dev, arch):
    """Engine on the CUDA kernels (RG-LRU scan, sampler) against
    EngineReference (plain versions), greedy, token for token, on the
    reduced configs at float32; the RG-LRU kernel launches once per R layer
    per decode tick and prefill-scan step; Model.prefill runs the SSD
    kernel once per layer."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models.transformer import hybrid_pattern
    from repro_torch.serve import (Engine, EngineReference, mixed_requests,
                                   run_staggered, staggered_groups)
    cfg = reduced(get_config(arch), dtype="float32")
    model = build_model(cfg, max_seq=40, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def reqs():
        return mixed_requests(6, seed=5, vocab=cfg.vocab_size,
                              prompt_lens=(2, 9), max_new=(2, 8))

    ref = EngineReference(model, params, slots=3, max_len=40, device=dev)
    want = run_staggered(ref, staggered_groups(reqs(), 2))
    ops.reset_launches()
    eng = Engine(model, params, slots=3, max_len=40, ticks_per_sync=4,
                 device=dev)
    assert run_staggered(eng, staggered_groups(reqs(), 2)) == want
    n_rec = sum(k == "R" for k in hybrid_pattern(cfg)) \
        if cfg.family == "hybrid" else 0
    steps = eng.counts["decode_ticks"] + eng.counts["prefill_steps"]
    assert ops.launches["rglru_scan"] == n_rec * steps
    assert ops.launches["fused_sample"] == \
        eng.counts["decode_ticks"] + eng.counts["prefill_calls"]
    ops.reset_launches()
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device=dev)
    model.prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan"] == (cfg.num_layers if arch.startswith(
        "mamba2") else 0)
    assert ops.launches["rglru_scan"] == n_rec


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,K,Sq,Skv,hd,causal,window,cap,layout", [
    (1, 4, 2, 128, 128, 64, True, 0, 0.0, "pallas"),
    (2, 4, 4, 64, 64, 32, True, 0, 0.0, "pallas"),
    (1, 6, 2, 128, 128, 64, True, 48, 0.0, "pallas"),     # local window
    (1, 4, 1, 64, 64, 128, True, 0, 50.0, "pallas"),      # softcap + MQA
    (1, 2, 2, 64, 128, 64, False, 0, 0.0, "pallas"),      # cross attn
    (1, 4, 2, 1000, 1000, 256, True, 100, 30.0, "pallas"),  # ragged
    (2, 8, 2, 200, 200, 128, True, 0, 0.0, "model"),      # strided views
    (1, 8, 2, 1000, 1000, 128, True, 0, 0.0, "model"),    # ragged, hd 128
    (2, 4, 2, 300, 300, 16, True, 0, 0.0, "model"),       # reduced() hd 16
    (1, 4, 4, 200, 330, 16, False, 0, 30.0, "pallas"),
    (2, 8, 8, 500, 500, 96, True, 0, 0.0, "model"),       # phi3's hd 96
    (1, 6, 2, 400, 400, 96, True, 64, 50.0, "pallas"),
    (1, 4, 2, 700, 700, 256, True, 0, 0.0, "model"),      # hd 256, causal
])
def test_flash_attention_kernel_matches_plain(dev, dtype, B, H, K, Sq, Skv,
                                              hd, causal, window, cap,
                                              layout):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(2)

    def r(b, n, s):
        if layout == "model":     # (B, S, n, hd) storage, (B, n, S, hd) view
            return torch.randn(b, s, n, hd, generator=g, device=dev).to(
                dtype).transpose(1, 2)
        return torch.randn(b, n, s, hd, generator=g, device=dev).to(dtype)

    q, k, v = r(B, H, Sq), r(B, K, Skv), r(B, K, Skv)
    # the plain version computes in f32 from the inputs either way: on
    # their f32 copies it gives its output before the rounding to dtype
    want32, want_lse = fa.flash_attention_plain(
        q.float(), k.float(), v.float(), causal=causal, window=window,
        logit_cap=cap)
    before = ops.launches["flash_attention"]
    got, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   logit_cap=cap, return_lse=True)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    assert got.stride() == q.stride()
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want32.to(dtype).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    if dtype == torch.bfloat16:
        n = want32.norm(dim=-1).clamp(min=1e-30)
        row = (got.float() - want32).norm(dim=-1) / n
        assert float(row.max()) <= FLASH_BF16_ROW_REL


@pytest.mark.parametrize("B,S,H,K,hd,window,cap", [
    (2, 512, 8, 2, 128, 0, 0.0),
    (2, 300, 4, 2, 16, 64, 30.0),
    (1, 400, 6, 2, 96, 0, 50.0),
])
def test_flash_attention_bf16_gradients_match_plain_autograd(
        dev, B, S, H, K, hd, window, cap):
    """``FlashAttention`` in bf16 (the kernel's o and lse forward, the plain
    backward recomputing p = exp(s - lse)) against f32 autograd of the
    plain version: dq, dk, dv within ``FLASH_BF16_GRAD_REL`` in relative
    Frobenius norm, so a wrong bf16 lse shows in the gradients."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import chunked_attention
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, do = (torch.randn(B, S, n, hd, generator=g, device=dev).to(
        torch.bfloat16) for n in (H, K, K, H))

    def plain(q, k, v):
        return fa.flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            window=window, logit_cap=cap)[0].transpose(1, 2)

    def grads(f, dtype):
        leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad((f(*leaves).float() * do.float()).sum(),
                                   leaves)

    want = grads(plain, torch.float32)
    before = ops.launches["flash_attention"]
    got = grads(lambda q, k, v: chunked_attention(
        q, k, v, window=window, logit_cap=cap, kv_block=128),
        torch.bfloat16)
    assert ops.launches["flash_attention"] == before + 1
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16 and bool(torch.isfinite(x).all())
        assert float((x.float() - w).norm() / w.norm()) \
            <= FLASH_BF16_GRAD_REL


def test_train_step_kernel_matches_plain(dev):
    """Reduced llama3-8b (head_dim 16, f32, remat full) through the flash
    kernel against the plain path (naive attention under autograd): the
    gradients within the bounds of ``tests/test_models.py`` (rtol 3e-4,
    atol 3e-5), and one train step's loss and grad_norm within 1e-5; two
    kernel launches per layer (forward and remat recompute)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, device_batch_at
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.train.trainer import (clone_state, init_state,
                                           make_train_step)
    cfg = reduced(get_config("llama3-8b"), dtype="float32", remat="full")
    model = build_model(cfg, max_seq=256, device=dev)
    opt = AdamW(lr=constant(1e-3))
    state = init_state(model, opt, torch.Generator(device=dev).manual_seed(0))
    batch = device_batch_at(DataConfig(cfg.vocab_size, 256, 4), 0, dev)
    grads, metrics, launched = {}, {}, {}
    for impl in ("plain", "kernel"):
        leaves = {n: p.detach().requires_grad_()
                  for n, p in state["params"].items()}
        ops.reset_launches()
        loss = model.loss(leaves, batch, attn_impl=impl)
        grads[impl] = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        torch.cuda.synchronize()
        launched[impl] = ops.launches["flash_attention"]
        _, metrics[impl] = make_train_step(model, opt, attn_impl=impl)(
            clone_state(state), batch)
    assert launched == {"plain": 0, "kernel": 2 * cfg.num_layers}
    for n, g in grads["kernel"].items():
        torch.testing.assert_close(g, grads["plain"][n], atol=3e-5,
                                   rtol=3e-4)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(metrics["kernel"][key],
                                   metrics["plain"][key], atol=1e-5,
                                   rtol=1e-5)
