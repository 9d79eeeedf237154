"""The port's CUDA kernels against their plain versions, the two scans
under autograd against plain autograd, a train step on the flash kernel
against the plain path and one of every family on its kernels, the paged
engine and the recurrent families' engine on their kernels against
``EngineReference``, the moe family's engines on their kernels against
their plain twins, the dense engine's faults and retries on its
kernels, the traffic count of an engine and a train window against the
CPU's, and the encdec family's kernels at whisper's shapes and its
engine on its kernels against its plain twin, on the card.

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
# The engine's flash encoder against the naive encoder on the same stub
# frames, bf16: each (row, frame)'s relative L2 difference over d_model
# (``chip_smoke.py``'s limit, read there at 9.2e-3 at full width).
ENCODER_ROUTE_REL = 2e-2
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
    (8, 24, 8, 1024, 64, 0, 0.0),      # granite-moe-3b-a800m's heads
    (8, 16, 16, 1024, 128, 0, 0.0),    # moonshot-v1-16b-a3b's
    (8, 48, 8, 1024, 128, 0, 0.0),     # internvl2-26b's
    (8, 6, 6, 1536, 64, 0, 0.0),       # whisper-tiny's, 1536 rows
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
                                 (1, 128256), (64, 128256),
                                 # granite, moonshot and internvl2 vocabs
                                 (8, 49155), (8, 163840), (8, 92553)])
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
    (8, 24, 8, 64, 8, 128, 64, 0, 0.0),       # granite-moe-3b-a800m
    (8, 16, 16, 128, 8, 128, 64, 0, 0.0),     # moonshot-v1-16b-a3b
    (8, 48, 8, 128, 8, 128, 64, 0, 0.0),      # internvl2-26b
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("pos0", [0, 5, 700])
def test_decode_kernels_propagate_a_nan_key_row(dev, dtype, paged, pos0):
    """NaN in the K and V rows of one key of one slot (as a corrupt cache
    page or row is) makes that slot's output NaN through both decode
    kernels, as through their plain versions, whether its live keys lie in
    one chunk or span the cluster (pos 900, the NaN key at 0, 5 or 700); every other slot stays within
    bound.  A kernel that dropped the NaN chunk from its cluster combine
    returned a finite, wrong row, which no health check could see."""
    from repro_torch.kernels import paged_attention as pa
    B, H, K, hd, L, ps = 4, 8, 2, 128, 1024, 8
    g = torch.Generator(device=dev).manual_seed(1)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, nk, nv = r(B, H, hd), r(B, K, hd), r(B, K, hd)
    pos = torch.tensor([900, 40, 700, 3], dtype=torch.int32, device=dev)
    tol = TOL[dtype]
    if paged:
        nb = L // ps
        k, v = r(B * nb + 1, ps, K, hd), r(B * nb + 1, ps, K, hd)
        pt = torch.arange(B * nb, dtype=torch.int32,
                          device=dev).reshape(B, nb)
        k[pt[0, pos0 // ps], pos0 % ps] = float("nan")
        v[pt[0, pos0 // ps], pos0 % ps] = float("nan")
        kp, vp = k.clone(), v.clone()
        want = pa.paged_decode_attention_fused_plain(q, kp, vp, nk, nv, pt,
                                                     pos)
        got = ops.paged_decode_attention_fused(q, k, v, nk, nv, pt, pos)
    else:
        k, v = r(B, L, K, hd), r(B, L, K, hd)
        k[0, pos0], v[0, pos0] = float("nan"), float("nan")
        kp, vp = k.clone(), v.clone()
        want = da.decode_attention_fused_plain(q, kp, vp, nk, nv, pos)
        got = ops.decode_attention_fused(q, k, v, nk, nv, pos)
    torch.cuda.synchronize()
    assert torch.isnan(want[0].float()).all()
    assert torch.isnan(got[0].float()).all()
    torch.testing.assert_close(got[1:].float(), want[1:].float(), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("fault,count", [("nan_logits", 1),
                                         ("window_stall", 3)])
def test_engine_faults_stay_on_the_kernels(dev, fault, count):
    """A NaN row through the CUDA sampler is quarantined and retried to the
    reference's output; a watchdog that degrades after three launch-gate
    stalls still launches the decode kernel once per layer and tick, and
    the sampler once per tick and prefill: no plain path runs.  Reduced
    llama3-8b (head_dim 16) at float32."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import (DONE, Engine, EngineReference, Fault,
                                   FaultPlan, WindowWatchdog, mixed_requests,
                                   run_staggered, staggered_groups)
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=48, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def reqs():
        return mixed_requests(6, seed=3, prompt_lens=(2, 9), max_new=(4, 10))

    ref = EngineReference(model, params, slots=3, max_len=48, device=dev)
    want = run_staggered(ref, staggered_groups(reqs(), 3))
    plan = FaultPlan([Fault(fault, at=1, count=count, slot=0)])
    ops.reset_launches()
    eng = Engine(model, params, slots=3, max_len=48, ticks_per_sync=4,
                 device=dev, fault_plan=plan,
                 watchdog=WindowWatchdog(backoff_s=0.0))
    rs_ = reqs()
    assert run_staggered(eng, staggered_groups(rs_, 3)) == want
    assert all(r.state == DONE for r in rs_)
    rs = eng.resilience_stats()
    if fault == "nan_logits":
        assert rs["quarantined"] == rs["retried"] == 1
    else:
        assert rs["window_fallbacks"] == 1 and rs["degraded"]
    ticks, calls = eng.counts["decode_ticks"], eng.counts["prefill_calls"]
    assert ops.launches["decode_attention"] == cfg.num_layers * ticks
    assert ops.launches["fused_sample"] == ticks + calls


def test_error_inside_a_window_propagates_on_the_card(dev, monkeypatch):
    """An error raised inside the window leaves ``step()`` unretried."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, FaultPlan, Request
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=48, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, params, slots=2, max_len=48, ticks_per_sync=2,
                 device=dev, fault_plan=FaultPlan([]))
    eng.submit(Request(uid=0, prompt=[3, 4, 5], max_new_tokens=6))
    eng._admit()

    def broken(*a, **k):
        raise RuntimeError("fault inside the window")

    monkeypatch.setattr(ops, "fused_sample", broken)
    with pytest.raises(RuntimeError, match="inside the window"):
        eng.step()
    assert eng.resilience_stats()["window_retries"] == 0


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "B,H,K,Sq,Skv,hd,causal,window,cap,q_offset,kv_len,p_bf16", [
        (4, 8, 2, 1, 300, 128, True, 0, 0.0, 0, 1, False),   # first key
        (4, 8, 2, 1, 300, 128, True, 0, 0.0, 149, 150, False),  # mid tile
        (4, 8, 2, 1, 300, 128, True, 0, 50.0, 299, 300, False),
        (4, 8, 2, 1, 300, 128, True, 100, 0.0, 257, 258, False),
        (2, 8, 8, 1, 500, 96, True, 64, 30.0, 400, 401, False),
        (2, 4, 1, 1, 700, 256, True, 0, 0.0, 600, 601, False),
        (2, 4, 2, 1, 200, 16, True, 0, 0.0, 130, 131, False),
        (2, 8, 2, 100, 300, 128, True, 0, 0.0, 200, 300, False),  # chunk
        (1, 8, 2, 129, 700, 128, True, 128, 0.0, 500, 650, False),
        (2, 8, 2, 150, 300, 64, False, 0, 0.0, 0, 170, False),  # non-causal
        (1, 4, 2, 200, 600, 128, False, 100, 30.0, 300, 580, False),
        (2, 8, 2, 100, 300, 128, True, 0, 0.0, 200, 300, True),   # p_bf16
        (4, 8, 2, 1, 300, 128, True, 0, 0.0, 149, 150, True),
    ])
def test_flash_attention_positions_match_plain(dev, dtype, B, H, K, Sq, Skv,
                                               hd, causal, window, cap,
                                               q_offset, kv_len, p_bf16):
    """The flash kernel with a query offset, a valid-key length (inside a
    kv tile too), non-causal masks and ``p_bf16`` (f32 inputs: P rounded
    to bf16, as the bf16 variant always does) against its plain version
    in the model's strided layout: o within ``TOL`` (``p_bf16``: bf16's),
    lse within 1e-5; keys at and past ``kv_len`` hold NaN, which must not
    reach the output (no tile past kv_len is read and a dead key's p is
    0; a NaN key inside the last live tile is masked before the max)."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(5)

    def r(n, s):            # (B, S, n, hd) storage, (B, n, S, hd) view
        return torch.randn(B, s, n, hd, generator=g, device=dev).to(
            dtype).transpose(1, 2)

    q, k, v = r(H, Sq), r(K, Skv), r(K, Skv)
    k[:, :, kv_len:] = float("nan")
    kw = dict(causal=causal, window=window, logit_cap=cap,
              q_offset=q_offset, kv_len=kv_len)
    want32, want_lse = fa.flash_attention_plain(q.float(), k.float(),
                                                v.float(), p_bf16=p_bf16,
                                                **kw)
    before = ops.launches["flash_attention"]
    got, lse = ops.flash_attention(q, k, v, p_bf16=p_bf16, return_lse=True,
                                   **kw)
    torch.cuda.synchronize()
    assert ops.launches["flash_attention"] == before + 1
    tol = 2e-2 if p_bf16 or dtype == torch.bfloat16 else TOL[dtype]
    torch.testing.assert_close(got.float(), want32.to(dtype).float(),
                               atol=tol, rtol=tol)
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, q_offset=torch.tensor(q_offset,
                                                           device=dev))


def test_scalar_decode_and_kernel_prefill_on_the_card(dev):
    """Reduced llama3-8b and gemma2-27b (f32, window 8): ``Model.prefill``
    through the flash kernel against the plain route (1e-4), scalar
    ``decode_step`` through the flash kernel reproducing the train
    forward's logits (2e-3, JAX's decode-vs-forward bound) with one launch
    a layer and step, and ``Engine(prefill_attn_impl="kernel")`` equal to
    ``EngineReference`` token for token."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import (Engine, EngineReference, mixed_requests,
                                   run_staggered, staggered_groups)
    for arch, over in (("llama3-8b", {}), ("gemma2-27b",
                                           {"local_window": 8})):
        cfg = reduced(get_config(arch), dtype="float32", **over)
        model = build_model(cfg, max_seq=64, device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (2, 20), device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(1))
        ops.reset_launches()
        lk, ck = model.prefill(params, {"tokens": toks})
        assert ops.launches["flash_attention"] == cfg.num_layers
        lp, cp = model.prefill(params, {"tokens": toks}, attn_impl="plain")
        torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-4)
        full, _, _ = model.forward(params, {"tokens": toks}, mode="train",
                                   attn_impl="plain")
        cache = model.init_cache(2, 20)
        for t in range(20):
            ops.reset_launches()
            lg, cache = model.decode_step(params, cache,
                                          {"tokens": toks[:, t:t + 1]},
                                          torch.tensor(t, device=dev),
                                          attn_impl="kernel")
            assert ops.launches["flash_attention"] == cfg.num_layers
            torch.testing.assert_close(lg[:, 0], full[:, t].detach(),
                                       atol=2e-3, rtol=2e-3)

        def reqs():
            return mixed_requests(6, seed=3, vocab=cfg.vocab_size,
                                  prompt_lens=(3, 40), max_new=(2, 8))

        eng = Engine(model, params, slots=3, max_len=64,
                     prefill_attn_impl="kernel", device=dev)
        ref = EngineReference(model, params, slots=3, max_len=64,
                              device=dev)
        assert run_staggered(eng, staggered_groups(reqs(), 3)) == \
            run_staggered(ref, staggered_groups(reqs(), 3))


@pytest.mark.parametrize("B,S,H,K,hd,window,cap,causal,Skv", [
    (2, 512, 8, 2, 128, 0, 0.0, True, None),
    (2, 300, 4, 2, 16, 64, 30.0, True, None),
    (1, 400, 6, 2, 96, 0, 50.0, True, None),
    (2, 1500, 6, 6, 64, 0, 0.0, False, None),   # whisper's encoder
    (2, 448, 6, 6, 64, 0, 0.0, False, 1500),    # its cross-attention
])
def test_flash_attention_bf16_gradients_match_plain_autograd(
        dev, B, S, H, K, hd, window, cap, causal, Skv):
    """``FlashAttention`` in bf16 (the kernel's o and lse forward, the plain
    backward recomputing p = exp(s - lse)) against f32 autograd of the
    plain version: dq, dk, dv within ``FLASH_BF16_GRAD_REL`` in relative
    Frobenius norm, so a wrong bf16 lse shows in the gradients; causal,
    and non-causal at whisper's encoder shape and at its cross-attention's
    (S queries over ``Skv`` keys of another source)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.attention import chunked_attention
    g = torch.Generator(device=dev).manual_seed(4)
    Skv = S if Skv is None else Skv
    q, k, v, do = (torch.randn(B, s, n, hd, generator=g, device=dev).to(
        torch.bfloat16) for s, n in ((S, H), (Skv, K), (Skv, K), (S, H)))

    def plain(q, k, v):
        return fa.flash_attention_plain(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, logit_cap=cap)[0].transpose(1, 2)

    def grads(f, dtype):
        leaves = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad((f(*leaves).float() * do.float()).sum(),
                                   leaves)

    want = grads(plain, torch.float32)
    before = ops.launches["flash_attention"]
    got = grads(lambda q, k, v: chunked_attention(
        q, k, v, causal=causal, window=window, logit_cap=cap,
        kv_block=128), torch.bfloat16)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,S,H,P,N,chunk,s0", [
    (2, 512, 4, 64, 128, 256, True),    # mamba2's P, N and chunk
    (1, 200, 3, 24, 40, 100, False),    # ragged tiles
])
def test_ssd_scan_autograd_matches_plain_autograd(dev, dtype, b, S, H, P, N,
                                                  chunk, s0):
    """``SSDScan`` (the kernel forward, the plain backward) against
    plain autograd of ``ssd_scan_plain`` from the same inputs and upstream
    gradients: equal within ``TOL`` (its backward is the plain one at the
    saved inputs); one kernel launch, in the forward."""
    from repro_torch.kernels import ssd_scan as ssd
    args = _ssd_inputs(dev, dtype, b, S, H, P, N, 11, s0)
    xs = [t.detach().requires_grad_() for t in args if t is not None]
    g = torch.Generator(device=dev).manual_seed(12)
    dy = torch.randn(args[0].shape, generator=g, device=dev).to(dtype)
    ds = torch.randn((b, H, P, N), generator=g, device=dev)
    s_in = xs[5] if s0 else None
    want = torch.autograd.grad(
        ssd.ssd_scan_plain(*xs[:5], chunk=chunk, s0=s_in), xs, (dy, ds))
    before = ops.launches["ssd_scan"]
    got = torch.autograd.grad(ops.SSDScan.apply(*xs[:5], chunk, s_in), xs,
                              (dy, ds))
    torch.cuda.synchronize()
    assert ops.launches["ssd_scan"] == before + 1
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), w.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])


def test_ssd_backward_memory_is_flat_in_sequence_length(dev):
    """``SSDScan``'s backward at mamba2-1.3b's heads (a training
    microbatch: b 2, H 64, P 64, N 128, chunk 256, bf16) at S 4096 (16
    chunks, one group at ``GROUP_ELEMENTS``) and S 16384 (64 chunks, 4
    groups): the memory the backward adds above its inputs, outputs and
    upstream gradients grows by less than 2x for 4x the tokens (every
    chunk at once would grow it 4x)."""
    from repro_torch.kernels import ssd_scan as ssd
    b, H, P, N, chunk = 2, 64, 64, 128, 256
    extra = {}
    for S in (4096, 16384):
        args = _ssd_inputs(dev, torch.bfloat16, b, S, H, P, N, 14)
        xs = [t.detach().requires_grad_() for t in args[:5]]
        y, _ = ops.SSDScan.apply(*xs, chunk, None)
        dy = torch.ones_like(y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads = torch.autograd.grad(y, xs, dy)
        torch.cuda.synchronize()
        extra[S] = torch.cuda.max_memory_allocated() - base
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        del args, xs, y, dy, grads
        torch.cuda.empty_cache()
        print(f"SSD backward, b {b} x S {S}: {extra[S] / 2**30:.3f} GiB "
              f"above its inputs, {extra[S] / (b * S) / 2**10:.1f} KiB a "
              f"token")
    assert extra[16384] < 2 * extra[4096], extra


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,R", [(4, 2048, 2560), (3, 37, 100)])
def test_rglru_gated_scan_autograd_matches_plain_autograd(dev, dtype, B, S,
                                                          R):
    """``RGLRUGatedScan`` (gated kernel forward; backward: the ungated
    kernel for h, then for the reversed adjoint, and the gate chain)
    against plain autograd of ``rglru_gated_scan_plain``, from h0 with an
    upstream gradient on the final state: within ``TOL``; three launches."""
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device=dev).manual_seed(13)

    def r(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    xs = [r(B, S, R).to(dtype), torch.sigmoid(r(B, S, R)).to(dtype),
          torch.sigmoid(r(B, S, R)).to(dtype), r(R).to(dtype), r(B, R)]
    xs = [t.requires_grad_() for t in xs]
    dy, dh = r(B, S, R).to(dtype), r(B, R)
    want = torch.autograd.grad(rg.rglru_gated_scan_plain(*xs), xs, (dy, dh))
    before = ops.launches["rglru_scan"]
    got = torch.autograd.grad(ops.RGLRUGatedScan.apply(*xs), xs, (dy, dh))
    torch.cuda.synchronize()
    assert ops.launches["rglru_scan"] == before + 3
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), w.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b",
                                  "granite-moe-3b-a800m",
                                  "moonshot-v1-16b-a3b", "internvl2-26b",
                                  "whisper-tiny"])
def test_train_step_of_every_family_on_the_kernels(dev, arch):
    """One reduced train step (f32, remat full) of each family through its
    kernels: every parameter's gradient present and finite, the loss
    within rel 1e-4 of the plain path's (naive attention, plain scans),
    and the kernel launches the step implies: per layer a forward and a
    remat recompute (``ssd_scan``, flash), and for an R layer also the
    RG-LRU backward's two ungated launches; whisper's batch carries 192
    frames a row beside its 256 tokens (per encoder layer the non-causal
    flash call, per decoder layer the causal one and the cross-attention
    at Sq 256, Skv 192)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, device_batch_at
    from repro_torch.models import build_model
    from repro_torch.models.transformer import hybrid_pattern
    cfg = reduced(get_config(arch), dtype="float32", remat="full")
    model = build_model(cfg, max_seq=256, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = device_batch_at(DataConfig(cfg.vocab_size, 256, 4), 0, dev)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn(
            (4, cfg.vision_tokens, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
    if cfg.family == "encdec":
        batch["frames"] = torch.randn(
            (4, 192, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
    losses = {}
    for impl in ("plain", "kernel"):
        leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
        ops.reset_launches()
        loss = model.loss(leaves, batch, attn_impl=impl)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        losses[impl] = float(loss)
        assert all(g is not None and bool(torch.isfinite(g).all())
                   for g in grads)
    L = cfg.num_layers
    if cfg.family == "ssm":
        want = {"ssd_scan": 2 * L}
    elif cfg.family == "hybrid":
        n_rec = hybrid_pattern(cfg).count("R")
        want = {"rglru_scan": 4 * n_rec, "flash_attention": 2 * (L - n_rec)}
    elif cfg.family == "encdec":
        want = {"flash_attention": 2 * (cfg.enc_layers
                                        + 2 * cfg.dec_layers)}
    else:
        want = {"flash_attention": 2 * L}
    assert {k: v for k, v in ops.launches.items() if v} == want
    assert abs(losses["kernel"] - losses["plain"]) \
        <= 1e-4 * abs(losses["plain"])


# The train launcher on the card, one family a case: full width at the
# depth given (mamba2-1.3b and whisper-tiny at full depth; the others cut
# so that the state and its closing checkpoint stay small), peak lr 1e-4 x min(1,
# 2048 / d_model) as the smoke's full-width train slices run (mamba2
# diverges at the launcher's default 1e-3, PERF.md)
LAUNCHED_FAMILIES = [("mamba2-1.3b", None), ("recurrentgemma-2b", 3),
                     ("granite-moe-3b-a800m", 4), ("moonshot-v1-16b-a3b", 1),
                     ("internvl2-26b", 1), ("whisper-tiny", None)]


@pytest.mark.parametrize("arch,layers", LAUNCHED_FAMILIES)
def test_launcher_trains_every_family_on_the_card(dev, arch, layers,
                                                 tmp_path, capsys):
    """``launch.train --arch <arch> [--layers N] --steps 16
    --steps-per-sync 4 --verdicts``: exit 0, the family's kernel launches
    for 16 steps of the config's remat, finite losses whose last window's
    mean is below the first's, and the train verdict line with finite
    positive ratios.  The checkpoint it writes is removed after the case.
    (16 steps: warmup_cosine's 10 warmup steps reach the peak; in 8, at
    1024 tokens a step, recurrentgemma's window means moved by 2e-3,
    within their noise.)"""
    import dataclasses
    import math
    import re
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models.transformer import hybrid_pattern
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    lr = 1e-4 * min(1.0, 2048 / cfg.d_model)
    args = ["--arch", arch, "--steps", "16", "--steps-per-sync", "4",
            "--lr", f"{lr:.6g}", "--verdicts", "--ckpt-dir",
            str(tmp_path / "ckpt")]
    if layers is not None:
        args += ["--layers", str(layers)]
    ops.reset_launches()
    try:
        assert launch_train.main(args) == 0
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)
        torch.cuda.empty_cache()
    out = capsys.readouterr().out
    print(f"launch.train {' '.join(args)}\n{out}")
    assert f"arch={arch} layers={cfg.num_layers}" in out and "done @16" in out
    L, n = cfg.num_layers, 16
    per = 1 if cfg.remat == "none" else 2       # forward (+ remat recompute)
    if cfg.family == "ssm":
        want = {"ssd_scan": per * L * n}
    elif cfg.family == "hybrid":
        rec = hybrid_pattern(cfg).count("R")
        want = {"rglru_scan": (per + 2) * rec * n,
                "flash_attention": per * (L - rec) * n}
    elif cfg.family == "encdec":     # tokens alone: the decoder's calls
        want = {"flash_attention": per * cfg.dec_layers * n}
    else:
        want = {"flash_attention": per * L * n}
    assert {k: v for k, v in ops.launches.items() if v} == want
    means = [float(m) for m in re.findall(r"window mean (\S+)\)", out)]
    assert len(means) == 4 and all(math.isfinite(m) for m in means)
    assert means[-1] < means[0], means
    ratios = re.findall(r"train_window_b8_s128_k4: energy vs SRAM STT (\S+) "
                        r"/ SOT (\S+)   EDP STT (\S+) / SOT (\S+)", out)
    assert len(ratios) == 1, out
    assert all(math.isfinite(float(x)) and float(x) > 0 for x in ratios[0])


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def test_traffic_count_on_card_equals_cpu(dev):
    """The traffic records of a reduced llama3-8b ``Engine`` (f32, 3 slots
    x 32, its decode window and every prefill length) and of a reduced
    ``TrainWindow`` (remat full) on the card equal the CPU's, record for
    record and op for op: the kernel boundary counts what the plain
    versions' does, and the backward that autograd runs on a worker
    thread on the card, with its remat recompute, is counted."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, constant
    from repro_torch.serve import (Engine, mixed_requests, run_staggered,
                                   staggered_groups)
    from repro_torch.train.trainer import init_state, make_train_window
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    params = build_model(cfg, max_seq=32, device="cpu").init(
        torch.Generator().manual_seed(0))
    stats, recs = {}, {}
    for d in (dev, torch.device("cpu")):
        eng = Engine(build_model(cfg, max_seq=32, device=d), _to(params, d),
                     slots=3, max_len=32, ticks_per_sync=4, device=d)
        reqs = mixed_requests(6, seed=1, vocab=cfg.vocab_size,
                              prompt_lens=(2, 12), max_new=(2, 6))
        run_staggered(eng, staggered_groups(reqs, 3))
        tr = eng._traffic
        stats[d.type] = [tr["decode"]] + [tr["prefill"][P]
                                          for P in sorted(tr["prefill"])]
        recs[d.type] = eng.serve_records()
    assert stats["cuda"] == stats["cpu"]
    assert recs["cuda"] == recs["cpu"] and len(recs["cpu"]) >= 2
    tcfg = reduced(get_config("llama3-8b"), remat="full")
    opt = AdamW(lr=constant(1e-3))
    state = init_state(build_model(tcfg, max_seq=32, device="cpu"), opt,
                       torch.Generator().manual_seed(0))
    train = {}
    for d in (dev, torch.device("cpu")):
        win = make_train_window(build_model(tcfg, max_seq=32, device=d),
                                opt, steps_per_sync=2,
                                data_cfg=DataConfig(tcfg.vocab_size, 32, 2))
        win(_to(state, d))
        train[d.type] = (win._traffic, win.train_records())
    assert train["cuda"] == train["cpu"]
    assert train["cpu"][0].kernel_calls == {
        "flash_attention": 2 * 2 * tcfg.num_layers}


def _granite(dev, max_seq=64):
    """Reduced granite-moe-3b-a800m (head_dim 16, 8 experts padded to 16,
    top-2) at float32 with seeded weights."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    cfg = reduced(get_config("granite-moe-3b-a800m"), dtype="float32")
    model = build_model(cfg, max_seq=max_seq, device=dev)
    return model, model.init(torch.Generator(device=dev).manual_seed(0))


def test_moe_decode_window_has_no_host_sync(dev):
    """A reduced granite ``Engine`` runs its first (counted) and second
    decode windows under the "error" sync-debug mode: the dispatch's
    sort, ranks and gathers keep fixed shapes and never wait on the
    card."""
    from repro_torch.serve import Request
    from repro_torch.serve import Engine
    model, params = _granite(dev)
    eng = Engine(model, params, slots=3, max_len=64, ticks_per_sync=4,
                 device=dev)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=list(range(1 + i, 30 + i)),
                           max_new_tokens=9))
    eng._admit()
    eng._pre_window()
    before = ops.launches["decode_attention"]
    for _ in range(2):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = eng._window()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng._traffic["decode"] is not None
    assert ops.launches["decode_attention"] - before == \
        2 * 4 * model.cfg.num_layers
    assert bool((out[0] >= 0).all())


@pytest.mark.parametrize("paged", [False, True])
def test_moe_engine_kernels_match_their_plain_twin(dev, paged):
    """The kernel ``Engine`` / ``PagedEngine`` against the same engine on
    the plain attention and sampler, greedy, token for token, on reduced
    granite (head_dim 16): the same dispatch, so the same drops; one
    attention launch per layer and tick, one sampler launch per tick and
    prefill."""
    from repro_torch.serve import (Engine, PagedEngine, mixed_requests,
                                   run_staggered, shared_prefix_requests,
                                   staggered_groups)
    model, params = _granite(dev)
    cls, kw = (PagedEngine, {"page_size": 8}) if paged else (Engine, {})

    def reqs():
        if paged:
            return shared_prefix_requests(6, seed=4, num_templates=2,
                                          template_len=26,
                                          suffix_lens=(2, 6), max_new=(2, 8))
        return mixed_requests(6, seed=9, vocab=model.cfg.vocab_size,
                              prompt_lens=(20, 32), max_new=(2, 8))

    plain = cls(model, params, slots=3, max_len=64, ticks_per_sync=4,
                attn_impl="plain", sample_impl="plain", device=dev, **kw)
    want = run_staggered(plain, staggered_groups(reqs(), 3))
    ops.reset_launches()
    eng = cls(model, params, slots=3, max_len=64, ticks_per_sync=4,
              device=dev, **kw)
    assert run_staggered(eng, staggered_groups(reqs(), 3)) == want
    attn = "paged_decode_attention" if paged else "decode_attention"
    assert ops.launches[attn] == \
        model.cfg.num_layers * eng.counts["decode_ticks"]
    assert ops.launches["fused_sample"] == \
        eng.counts["decode_ticks"] + eng.counts["prefill_calls"]


def test_moe_traffic_count_on_card_equals_cpu(dev):
    """A reduced granite ``Engine``'s traffic records (its decode window
    and every prefill length) on the card equal the CPU's op for op: the
    dispatch's sort, scatters and gathers count the same on both."""
    from repro_torch.serve import Engine, mixed_requests, run_staggered
    from repro_torch.serve import staggered_groups
    model, params = _granite(torch.device("cpu"))
    stats, recs = {}, {}
    for d in (dev, torch.device("cpu")):
        m, _ = _granite(d)
        eng = Engine(m, _to(params, d), slots=3, max_len=64,
                     ticks_per_sync=4, device=d)
        reqs = mixed_requests(6, seed=9, vocab=model.cfg.vocab_size,
                              prompt_lens=(20, 32), max_new=(2, 8))
        run_staggered(eng, staggered_groups(reqs, 3))
        tr = eng._traffic
        stats[d.type] = [tr["decode"]] + [tr["prefill"][P]
                                          for P in sorted(tr["prefill"])]
        recs[d.type] = eng.serve_records()
    assert stats["cuda"] == stats["cpu"]
    assert recs["cuda"] == recs["cpu"] and len(recs["cpu"]) >= 2


def _bits(t):
    """A float tensor's bits on the host (so that -0.0 != +0.0)."""
    t = t.detach().cpu().contiguous()
    return t.view(torch.uint8) if t.dtype == torch.int8 else t.view(
        {torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


@pytest.mark.parametrize("shards,shape", [(1, (4096, 4096)), (2, (1000, 37)),
                                          (4, (128256, 64)), (3, (5,))])
def test_compress_functions_on_card_equal_cpu_bitwise(dev, shards, shape):
    """``quantize`` (f32 and bf16), ``apply_error_feedback``,
    ``compressed_psum`` / ``compressed_psum_ef`` (sum and mean), a
    ``CompressedOptimizer`` update's error buffers and the scales of 256
    tensors whose maxima spread over 12 decades: the card's bits equal
    the CPU's on the same inputs (a division by a Python scalar on the
    card, a multiplication by its reciprocal, broke the mean at 3
    shards)."""
    from repro_torch.optim import (AdamW, apply_error_feedback,
                                   compressed_psum, compressed_psum_ef,
                                   constant, quantize, wrap_optimizer)
    g = torch.Generator().manual_seed(shards)
    x = torch.randn((shards,) + shape, generator=g) * 3
    e = torch.randn(shape, generator=g) * 1e-2
    # the scales of 256 tensors whose maxima spread over 12 decades
    rows = torch.randn(256, 8, generator=g).mul_(
        torch.logspace(-6, 6, 256)[:, None])
    out = {}
    for d in (dev, torch.device("cpu")):
        res = []
        for t in (x[0], x[0].to(torch.bfloat16)):
            q, s = quantize(t.to(d))
            res += [_bits(q), _bits(s.reshape(1))]
        comp, err = apply_error_feedback({"w": x[0].to(d)}, {"w": e.to(d)})
        res += [_bits(comp["w"]), _bits(err["w"])]
        for mean in (False, True):
            comb, errs = compressed_psum_ef({"w": x.to(d)}, mean=mean)
            res += [_bits(comb["w"]), _bits(errs["w"]),
                    _bits(compressed_psum({"w": x.to(d)}, mean=mean)["w"])]
        opt = wrap_optimizer(AdamW(lr=constant(1e-2)), shards)
        params = {"w": torch.zeros(shape, device=d)}
        state = opt.init(params)
        for _ in range(2):
            opt.update({"w": (x if shards > 1 else x[0]).to(d)}, state,
                       params)
        res.append(_bits(state["err"]["w"]))
        for t in rows:
            res.append(_bits(quantize(t.to(d))[1].reshape(1)))
        out[d.type] = res
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        assert torch.equal(a, b), i


def test_launcher_compresses_gradients_on_the_card(dev, tmp_path, capsys):
    """``launch.train --reduced --compress-grads --compress-shards 2
    --steps 20 --steps-per-sync 10``: exit 0, 4 layers x 2 shards x 20
    flash launches, falling window means and the verdict line."""
    import math
    import re
    from repro_torch.launch import train as launch_train
    ops.reset_launches()
    args = ["--reduced", "--compress-grads", "--compress-shards", "2",
            "--steps", "20", "--steps-per-sync", "10", "--ckpt-dir",
            str(tmp_path)]
    assert launch_train.main(args) == 0
    torch.cuda.synchronize()
    out = capsys.readouterr().out
    print(out)
    assert {k: v for k, v in ops.launches.items() if v} == \
        {"flash_attention": 4 * 2 * 20}
    means = [float(m) for m in re.findall(r"window mean (\S+)\)", out)]
    assert len(means) == 2 and all(math.isfinite(m) for m in means)
    assert means[-1] < means[0], means
    assert "train_window_b8_s128_k10: energy vs SRAM STT" in out


@pytest.mark.parametrize("tool", ["calibrate_cache", "calibrate_traffic"])
def test_calibration_tool_on_card_follows_cpu(dev, tool):
    """20 steps at lr 0.02 on the card and on the CPU: each iterate's loss
    within rel 1e-5 (``chip_smoke.py``'s ``TOOL_REL``), the same best
    step, the best loss at most the frozen constants'."""
    import importlib
    mod = importlib.import_module(f"repro_torch.tools.{tool}")
    card = mod.calibrate(20, 0.02, dev, log=None)
    cpu = mod.calibrate(20, 0.02, "cpu", log=None)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card[2], cpu[2]))
    print(f"{tool}: card {card[2]}\ncpu {cpu[2]}\nmax rel {rel:.3g}")
    assert len(card[2]) == 21 and rel <= 1e-5
    assert card[2].index(card[1]) == cpu[2].index(cpu[1])
    assert card[1] <= card[2][0]


# --- the encdec family (whisper-tiny) -----------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1536, 1], ids=["encoder", "cross"])
def test_flash_attention_at_whisper_shapes_matches_plain(dev, dtype, Sq):
    """The flash kernel non-causal at whisper-tiny's encoder shape (8, 6,
    1536, 1536, 64) and its decode tick's cross-attention (8, 6, 1, 1536,
    64): MHA (G = 1) in the model's strided layout, o within ``TOL`` (bf16
    rows within ``FLASH_BF16_ROW_REL``), lse within 1e-5."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=dev).manual_seed(27)

    def r(s):               # (B, S, H, hd) storage, (B, H, S, hd) view
        return torch.randn(8, s, 6, 64, generator=g, device=dev).to(
            dtype).transpose(1, 2)

    q, k, v = r(Sq), r(1536), r(1536)
    want32, want_lse = fa.flash_attention_plain(q.float(), k.float(),
                                                v.float(), causal=False)
    before = ops.launches["flash_attention"]
    got, lse = ops.flash_attention(q, k, v, causal=False, return_lse=True)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_engine_encoder_matches_the_naive_encoder(dev, dtype):
    """Reduced whisper-tiny: the ``enc/out`` rows that ``Engine`` writes at
    an admission of 3 requests (its fixed-shape flash encoder call)
    against ``encoder_forward(..., "plain")`` on the same stub frames:
    within ``TOL`` in f32, each (row, frame) within ``ENCODER_ROUTE_REL``
    in bf16."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine, Request
    cfg = reduced(get_config("whisper-tiny"), dtype=dtype)
    model = build_model(cfg, max_seq=64, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, params, slots=3, max_len=64, device=dev)
    prompts = [[5, 7, 11, 13], list(range(1, 41)), [3] * 17]
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=4))
    before = ops.launches["flash_attention"]
    eng._admit()
    assert ops.launches["flash_attention"] == before + cfg.enc_layers
    assert [eng.slot_req[s].uid for s in range(3)] == [0, 1, 2]
    tokens = torch.zeros(3, 64, dtype=torch.int32)
    for s, p in enumerate(prompts):
        tokens[s, :len(p)] = torch.tensor(p)
    live = (torch.arange(64)[None, :]
            < torch.tensor([len(p) for p in prompts])[:, None])
    emb = params["emb/tok"][tokens.to(dev)].to(eng.cache["enc/out"].dtype)
    want = tf.encoder_forward(cfg, params,
                              emb * live.to(dev)[:, :, None].to(emb.dtype),
                              "plain")
    got = eng.cache["enc/out"]
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        torch.testing.assert_close(got, want, atol=TOL[torch.float32],
                                   rtol=TOL[torch.float32])
    else:
        rel = ((got.float() - want.float()).norm(dim=-1)
               / want.float().norm(dim=-1).clamp(min=1e-30))
        assert float(rel.max()) <= ENCODER_ROUTE_REL


def test_encdec_engine_kernels_match_their_plain_twin(dev):
    """Reduced whisper-tiny at float32: the kernel ``Engine`` against the
    same engine on the plain attention and sampler and against
    ``EngineReference``, greedy, token for token; a decode tick launches
    the decode and flash kernels once a decoder layer and the sampler
    once, an admission the flash kernel once an encoder layer; the
    ``enc/out`` rows of ``Engine`` and ``EngineReference`` are the same
    bits; the decode window never waits on the card."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.serve import (Engine, EngineReference, Request,
                                   mixed_requests, run_staggered,
                                   staggered_groups)
    cfg = reduced(get_config("whisper-tiny"), dtype="float32")
    model = build_model(cfg, max_seq=64, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def reqs():
        return mixed_requests(6, seed=5, vocab=cfg.vocab_size,
                              prompt_lens=(2, 20), max_new=(2, 8))

    ref = EngineReference(model, params, slots=3, max_len=64, device=dev)
    want = run_staggered(ref, staggered_groups(reqs(), 3))
    plain = Engine(model, params, slots=3, max_len=64, ticks_per_sync=4,
                   attn_impl="plain", sample_impl="plain", device=dev)
    assert run_staggered(plain, staggered_groups(reqs(), 3)) == want
    ops.reset_launches()
    eng = Engine(model, params, slots=3, max_len=64, ticks_per_sync=4,
                 device=dev)
    assert run_staggered(eng, staggered_groups(reqs(), 3)) == want
    ticks, calls = eng.counts["decode_ticks"], eng.counts["prefill_calls"]
    assert ops.launches["decode_attention"] == cfg.dec_layers * ticks
    assert ops.launches["flash_attention"] == \
        cfg.dec_layers * ticks + cfg.enc_layers * calls
    assert ops.launches["fused_sample"] == ticks + calls
    eng.reset()
    ref.reset()
    eng.submit(Request(uid=0, prompt=[5, 7, 11, 13], max_new_tokens=9))
    eng._admit()
    ref._prefill(0, Request(uid=0, prompt=[5, 7, 11, 13], max_new_tokens=9))
    assert torch.equal(eng.cache["enc/out"][0], ref.cache["enc/out"][0])
    eng._pre_window()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = eng._window()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool((out[0, :, 0] >= 0).all())


# --- sharding: the one-rank NCCL group and the identity constrain -----------


@pytest.mark.parametrize("mean", [False, True])
def test_compressed_psum_ef_over_one_nccl_rank_is_the_stacked_form(dev,
                                                                   mean):
    """``compressed_psum_ef(group=)`` over a one-rank NCCL group: the
    combined value and the residual equal the stacked form of the one
    shard bit for bit (f32 and bf16), and the group is gone after."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import one_device_group
    from repro_torch.optim import compress as tc
    g = torch.Generator(device=dev).manual_seed(5)
    tree = {"a": torch.randn(1, 513, 7, generator=g, device=dev) * 3,
            "b": torch.randn(1, 999, generator=g,
                             device=dev).to(torch.bfloat16)}
    with one_device_group("cuda"):
        assert dist.get_backend() == "nccl"
        want, werr = tc.compressed_psum_ef(tree, mean=mean)
        got, err = tc.compressed_psum_ef(
            {k: v[0].clone() for k, v in tree.items()}, mean=mean,
            group=dist.group.WORLD)
    assert not dist.is_initialized()
    for k in tree:
        assert torch.equal(got[k], want[k]) and torch.equal(err[k],
                                                            werr[k][0])


def test_constrain_is_the_identity_on_the_card_and_the_decode_tick(dev):
    """Under a 1x1 NCCL mesh's ``activation_sharding``, ``constrain``
    returns a CUDA tensor itself, and ``Engine``'s fused decode tick on
    its kernels serves the same tokens as with no sharder."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import launcher_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, mixed_requests, run_staggered, \
        staggered_groups
    from repro_torch.sharding import activation_sharding, constrain, \
        default_rules
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=64, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def serve():
        eng = Engine(model, params, slots=4, max_len=64, ticks_per_sync=4,
                     device=dev)
        reqs = mixed_requests(8, seed=2, vocab=cfg.vocab_size,
                              prompt_lens=(2, 16), max_new=(2, 8))
        return run_staggered(eng, staggered_groups(reqs, 4)), eng

    want, _ = serve()
    x = torch.ones(2, 8, 4, device=dev)
    with launcher_mesh("cuda") as (mesh, _):
        with activation_sharding(mesh, default_rules()):
            assert constrain(x, ("batch", "seq", "embed_act")) is x
            before = ops.launches["decode_attention"]
            got, eng = serve()
    assert got == want
    assert ops.launches["decode_attention"] - before == \
        cfg.num_layers * eng.counts["decode_ticks"]
