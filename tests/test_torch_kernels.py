"""The port's kernels (``repro_torch.kernels``) against the JAX package's
Pallas kernels (interpret mode) and oracles, on the CPU.

On CPU tensors the port's wrappers take the kernels' plain versions, so
these tests pin the plain versions — the CUDA kernels' oracles — to the
JAX reference, and pin what the wrappers do around the kernels: argument
checks, device dispatch, launch counting and the build's error path.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import sampling as sm

TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py bounds


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp and a torch array of ``dtype`` (both round
    f32 to nearest-even, so bf16 bits agree)."""
    j = jnp.asarray(a, jnp.float32).astype(dtype)
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t


def _decode_setup(seed, B, H, K, L, hd, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, hd), (B, L, K, hd), (B, L, K, hd), (B, K, hd),
             (B, K, hd))]
    # positions span the edge cases: empty prefix, mid-block, block
    # boundary, last row of the cache
    pos = (np.arange(B, dtype=np.int32) * (L // 2 + 3)) % L
    pos[0], pos[-1] = 0, L - 1
    pairs = [_pair(a, dtype) for a in arrs]
    return pairs, (jnp.asarray(pos), torch.from_numpy(pos))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy().view(np.int32)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


# tests/test_kernels.py decode sweep: GQA / MHA / MQA, windows, softcaps
SWEEP = [
    (4, 4, 2, 128, 64, 0, 0.0, 32),       # GQA, global, multi-block
    (3, 4, 4, 64, 32, 0, 0.0, 64),        # MHA, single block
    (2, 4, 1, 128, 64, 24, 0.0, 32),      # MQA + local window
    (4, 6, 2, 96, 32, 8, 50.0, 32),       # softcap + window, odd L
    (5, 2, 2, 128, 64, 200, 30.0, 128),   # window > L == global
    (3, 4, 2, 64, 16, 0, 0.0, 32),        # reduced() configs' head_dim
    (4, 6, 3, 96, 96, 8, 30.0, 32),       # phi3-mini-3.8b's head_dim
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,K,L,hd,window,cap,bk", SWEEP)
def test_decode_attention_matches_jax(dtype, B, H, K, L, hd, window, cap,
                                      bk):
    """Fused: output within the JAX tests' bound of the Pallas kernel
    (interpret mode), cache write-back bitwise equal to the kernel's.
    Unfused, on the written cache: within bound of decode_attention_ref."""
    pairs, (jpos, tpos) = _decode_setup(4, B, H, K, L, hd, dtype)
    (jq, tq), (jk, tk), (jv, tv), (jnk, tnk), (jnv, tnv) = pairs
    jo, jck, jcv = jops.decode_attention_fused(
        jq, jk, jv, jnk, jnv, jpos, jnp.int32(window), logit_cap=cap, bk=bk,
        interpret=True)
    to = ops.decode_attention_fused(tq, tk, tv, tnk, tnv, tpos, window,
                                    logit_cap=cap)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=tol, atol=tol)
    np.testing.assert_array_equal(_bits(tk), _bits(jck))
    np.testing.assert_array_equal(_bits(tv), _bits(jcv))
    want = jref.decode_attention_ref(jq, jck, jcv, jpos, window,
                                     logit_cap=cap)
    got = ops.decode_attention(tq, tk, tv, tpos, window, logit_cap=cap)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_fused_write_touches_only_pos_rows():
    pairs, (_, tpos) = _decode_setup(5, 4, 4, 2, 128, 64, "float32")
    (_, q), (_, k), (_, v), (_, nk), (_, nv) = pairs
    k0, v0 = k.clone(), v.clone()
    ops.decode_attention_fused(q, k, v, nk, nv, tpos, 0)
    rows = torch.arange(4)
    changed = (k != k0).any(-1).any(-1) | (v != v0).any(-1).any(-1)
    expect = torch.zeros_like(changed)
    expect[rows, tpos.long()] = True
    assert torch.equal(changed, expect)
    assert torch.equal(k[rows, tpos.long()], nk)
    assert torch.equal(v[rows, tpos.long()], nv)


def _logits(seed, B, V):
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((B, V)) * 3.0).astype(np.float32)
    lg[0, [5, V // 2, V - 1]] = 40.0     # greedy tie across vocab blocks
    lg[1, :] = -np.inf
    lg[1, [7, 9]] = 0.0                  # tie after a -inf prefix
    return lg


@pytest.mark.parametrize("V", [1024, 1000])
@pytest.mark.parametrize("words", [(0, 0), (0x12345678, 0x9ABCDEF0),
                                   (0xFFFFFFFF, 1)])
def test_fused_sample_matches_jax(V, words):
    """Same logits, temperatures and key words: the port's sampler picks
    the tokens the Pallas kernel picks, greedy rows are the
    first-occurrence argmax."""
    B = 6
    lg = _logits(1, B, V)
    temps = np.array([0.0, 0.0, 0.5, 1.0, -1.0, 2.0], np.float32)
    jtok = jops.fused_sample(jnp.asarray(lg), jnp.asarray(temps),
                             jnp.asarray(words, jnp.uint32), interpret=True)
    ttok = ops.fused_sample(torch.from_numpy(lg), torch.from_numpy(temps),
                            torch.tensor(words, dtype=torch.int64))
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    greedy = temps <= 0
    np.testing.assert_array_equal(ttok.numpy()[greedy],
                                  np.argmax(lg, axis=-1)[greedy])
    assert ttok[0] == 5 and ttok[1] == 7


def test_murmur_hash_matches_uint32_arithmetic():
    """The int64-masked hash equals wrapping uint32 arithmetic in numpy."""
    rng = np.random.default_rng(2)
    h = rng.integers(0, 2 ** 32, size=4096, dtype=np.uint64).astype(
        np.uint32)
    want = h.copy()
    with np.errstate(over="ignore"):
        want ^= want >> np.uint32(16)
        want *= np.uint32(0x85EBCA6B)
        want ^= want >> np.uint32(13)
        want *= np.uint32(0xC2B2AE35)
        want ^= want >> np.uint32(16)
    got = sm._fmix(torch.from_numpy(h.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_gumbel_sample_tracks_softmax():
    """Temperature rows draw from softmax(x / t): over many keys the
    empirical frequencies approach the distribution."""
    V, n = 8, 4000
    lg = torch.tensor([[1.0, 0.0, -1.0, 2.0, 0.5, -0.5, 0.0, 1.5]])
    t = torch.tensor([0.8])
    counts = np.zeros(V)
    for s in range(n):
        key = torch.tensor([s, 7 * s + 3], dtype=torch.int64)
        counts[int(sm.fused_sample_plain(lg, t, key)[0])] += 1
    want = torch.softmax(lg[0] / 0.8, dim=0).numpy()
    np.testing.assert_allclose(counts / n, want, atol=0.03)


def test_wrappers_raise_off_cpu_and_cuda():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device raises instead of taking the plain version, and so do
    mixed devices."""
    meta = dict(device="meta")
    q = torch.empty(2, 4, 32, **meta)
    k = torch.empty(2, 8, 2, 32, **meta)
    pos = torch.zeros(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.decode_attention(q, k, k, pos, 0)
    with pytest.raises(ValueError, match="several devices"):
        ops.fused_sample(torch.zeros(2, 8), torch.zeros(2, **meta),
                         torch.zeros(2, dtype=torch.int64))


def test_plain_path_does_not_count_launches():
    ops.reset_launches()
    pairs, (_, tpos) = _decode_setup(6, 2, 4, 2, 16, 32, "float32")
    (_, q), (_, k), (_, v), (_, nk), (_, nv) = pairs
    ops.decode_attention_fused(q, k, v, nk, nv, tpos, 0)
    ops.fused_sample(torch.zeros(2, 8), torch.zeros(2),
                     torch.zeros(2, dtype=torch.int64))
    ops.flash_attention(torch.zeros(1, 2, 8, 32), torch.zeros(1, 1, 8, 32),
                        torch.zeros(1, 1, 8, 32))
    assert ops.launches == {"decode_attention": 0,
                            "paged_decode_attention": 0, "fused_sample": 0,
                            "cache_sim": 0, "cache_sim_ladder": 0,
                            "ssd_scan": 0, "rglru_scan": 0,
                            "flash_attention": 0}


@pytest.mark.parametrize("change,match", [
    (dict(hd=48), "head_dim"),
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(pos_dtype=torch.int64), "pos must be"),
    (dict(H=6), "does not fit"),
    (dict(window=np.int32(3)), "python int"),
    (dict(offset=1), "aligned"),
])
def test_decode_kernel_argument_checks(change, match):
    """What the CUDA wrapper refuses before it would launch."""
    a = dict(B=2, H=4, K=2, L=16, hd=64, dtype=torch.float32,
             pos_dtype=torch.int32, window=0, offset=0)
    a.update(change)
    n = a["B"] * a["H"] * a["hd"]
    q = torch.zeros(n + a["offset"], dtype=a["dtype"])[a["offset"]:].view(
        a["B"], a["H"], a["hd"])
    k = torch.zeros(a["B"], a["L"], 4 if a["H"] == 6 else a["K"], a["hd"],
                    dtype=a["dtype"])
    pos = torch.zeros(a["B"], dtype=a["pos_dtype"])
    with pytest.raises(ValueError, match=match):
        da.check_args(q, k, k, None, None, pos, a["window"])


def test_sample_kernel_argument_checks():
    with pytest.raises(ValueError, match="logits"):
        sm.check_args(torch.zeros(2, 8, dtype=torch.float64),
                      torch.zeros(2), torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="key"):
        sm.check_args(torch.zeros(2, 8), torch.zeros(2),
                      torch.zeros(2, dtype=torch.int32))


def test_build_names_by_source_hash_and_needs_nvcc(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a\n")
    a = _build._target(src)
    src.write_text("// b\n")
    assert _build._target(src) != a and a.parent == _build.BUILD_DIR
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "cache_sim.cu", "decode_attention.cu", "flash_attention.cu",
        "paged_attention.cu", "rglru_scan.cu", "sampling.cu", "ssd_scan.cu"]
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


# --- head dims -----------------------------------------------------------


def _attention_head_dims():
    """Every head_dim of the port's configs and of their ``reduced()``
    forms, for the configs that have attention heads."""
    dims = set()
    for arch in list_archs():
        cfg = get_config(arch)
        for c in (cfg, reduced(cfg)):
            if c.num_heads > 0:
                dims.add(c.head_dim)
    return dims


def test_every_config_head_dim_is_taken_by_the_attention_kernels():
    dims = _attention_head_dims()
    assert {16, 96, 128} <= dims
    for mod in (da, pa, fa):
        assert dims <= set(mod.HEAD_DIMS), mod.__name__


@pytest.mark.parametrize("hd,ok", [(16, True), (96, True), (48, False)])
def test_check_args_take_16_and_96_and_refuse_48(hd, ok):
    """The three attention wrappers' argument checks at the new head dims
    and at one that no config uses."""
    B, H, K = 2, 4, 2
    q, k = torch.zeros(B, H, hd), torch.zeros(B, 16, K, hd)
    pos = torch.zeros(B, dtype=torch.int32)
    pool, pt = torch.zeros(5, 4, K, hd), torch.zeros(B, 2, dtype=torch.int32)
    fq, fk = torch.zeros(B, H, 40, hd), torch.zeros(B, K, 40, hd)
    calls = (lambda: da.check_args(q, k, k, None, None, pos, 0),
             lambda: pa.check_args(q, pool, pool, None, None, pt, pos, 0),
             lambda: fa.check_args(fq, fk, fk, True, 0, 0.0))
    for call in calls:
        if ok:
            call()
        else:
            with pytest.raises(ValueError, match="head_dim"):
                call()


@pytest.mark.parametrize("wrapper", ["decode", "paged"])
@pytest.mark.parametrize("shift", [4, 8])
def test_decode_and_paged_check_args_refuse_unaligned_rows(wrapper, shift):
    """Both decode wrappers hold q, k and v to one alignment rule, 16
    bytes (the 16-byte cp.async of the split body both kernels run): a
    start ``shift`` bytes off is refused, an aligned one taken."""
    B, H, K, hd = 2, 4, 2, 32
    pos = torch.zeros(B, dtype=torch.int32)
    pool, pt = torch.zeros(5, 4, K, hd), torch.zeros(B, 2, dtype=torch.int32)
    cache = torch.zeros(B, 16, K, hd)

    def call(q):
        if wrapper == "decode":
            da.check_args(q, cache, cache, None, None, pos, 0)
        else:
            pa.check_args(q, pool, pool, None, None, pt, pos, 0)

    n = B * H * hd
    call(torch.zeros(n).view(B, H, hd))
    off = shift // 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(torch.zeros(n + off)[off:].view(B, H, hd))


# --- the split-K algebra of the decode kernel ------------------------------


def _split_decode(q, k, v, pos, window, chunk, splits, logit_cap=0.0,
                  paged=False):
    """split_decode.cuh's arithmetic in plain torch (f32): block r of a
    row's cluster takes chunks clo + r, clo + r + splits, ... of the live
    range [lo, last]; its partial (m, l, acc) runs an online softmax over
    its chunks; the partials combine with weights exp(m_r - max m), where a
    block with no live key offers (m = -inf, l = 0) and weighs 0.  k, v are
    (B, L, K, hd): a dense cache, or with ``paged`` each row's pages
    gathered, under the paged key policy's span (pos not clamped, last =
    min(pos, L - 1))."""
    B, H, hd = q.shape
    L, K = k.shape[1], k.shape[2]
    G = H // K
    out = torch.empty(B, H, hd)
    for b in range(B):
        p = int(pos[b]) if paged else min(max(int(pos[b]), 0), L - 1)
        lo = max(p - window + 1, 0) if window > 0 else 0
        p = min(p, L - 1)
        clo = lo // chunk
        nch = p // chunk - clo + 1
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G].float() * hd ** -0.5
            ms, ls, accs = [], [], []
            for r in range(splits):
                m = torch.full((G,), -float("inf"))
                l, acc = torch.zeros(G), torch.zeros(G, hd)
                for c in range(clo + r, clo + nch, splits):
                    t0, t1 = max(c * chunk, lo), min(c * chunk + chunk - 1, p)
                    kk = k[b, t0:t1 + 1, kh].float()
                    vv = v[b, t0:t1 + 1, kh].float()
                    s = qg @ kk.T
                    if logit_cap:
                        s = logit_cap * torch.tanh(s / logit_cap)
                    m_new = torch.maximum(m, s.amax(-1))
                    corr = torch.exp(m - m_new)
                    e = torch.exp(s - m_new[:, None])
                    l = l * corr + e.sum(-1)
                    acc = acc * corr[:, None] + e @ vv
                    m = m_new
                ms.append(m), ls.append(l), accs.append(acc)
            m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
            live = l > 0
            assert bool(live.any(0).all())
            top = torch.where(live, m, torch.full_like(m, -float("inf")))
            w = torch.where(live, torch.exp(m - top.amax(0)),
                            torch.zeros_like(m))
            total = (w * l).sum(0).clamp(min=1e-37)
            out[b, kh * G:(kh + 1) * G] = (w[..., None] * acc).sum(0) \
                / total[:, None]
    return out


@pytest.mark.parametrize("L,hd,chunk,splits,window,cap,pos", [
    # the kernel's geometry at f32 / hd 128: 64-key chunks, 16 of them
    # over a cluster of 8 blocks
    (1000, 128, 64, 8, 0, 0.0, [0, 63, 64, 999, 500, 130]),
    (1000, 128, 64, 8, 300, 30.0,
     [999, 299, 700, 64, 5, 650]),
    # small chunks: blocks without a live key, windows past whole chunks
    (100, 16, 16, 4, 0, 0.0, [0, 5, 99, 40, 15, 16]),
    (100, 16, 16, 8, 30, 50.0, [99, 29, 31, 70, 47, 0]),
    (96, 96, 32, 3, 0, 0.0, [95, 31, 32, 0, 64, 63]),
])
def test_split_decode_algebra_matches_plain(L, hd, chunk, splits, window, cap,
                                            pos):
    B, H, K = len(pos), 4, 2
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, hd), (B, L, K, hd), (B, L, K, hd)))
    p = torch.tensor(pos, dtype=torch.int32)
    want = da.decode_attention_plain(q, k, v, p, window, logit_cap=cap)
    got = _split_decode(q, k, v, p, window, chunk, splits, logit_cap=cap)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * scale)


@pytest.mark.parametrize("ps,nb,chunk,splits,window,cap,pos", [
    # bf16/hd 128 geometry at the smoke's pool: 128-key chunks, 8 blocks
    (8, 128, 128, 8, 0, 0.0, [512, 513, 640, 1023, 0, 127, 300]),
    # page size 5: chunk boundaries inside pages; rows at and past the end
    # of the table (keys up to nb*ps - 1)
    (5, 41, 64, 4, 0, 0.0, [204, 205, 230, 63, 64, 129]),
    (5, 41, 64, 4, 40, 30.0, [204, 230, 63, 64, 129, 10]),
    # a window that skips whole chunks, rows inside one chunk
    (8, 32, 32, 8, 50, 0.0, [255, 100, 31, 32, 0, 7]),
])
def test_split_paged_algebra_matches_plain(ps, nb, chunk, splits, window,
                                           cap, pos):
    """The paged instantiation of the split body: the same algebra over
    each row's gathered pages, with the paged span, equals the paged plain
    version, through shared pages and rows past the table."""
    B, H, K, hd = len(pos), 4, 2, 32
    rng = np.random.default_rng(12)
    P = B * nb + 1
    q = torch.from_numpy(rng.standard_normal((B, H, hd)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((P, ps, K, hd)).astype(
        np.float32)) for _ in range(2))
    pt = torch.arange(B * nb, dtype=torch.int32).view(B, nb)
    pt[1:3, :4] = pt[0, :4]                    # rows 0-2 share 4 pages
    p = torch.tensor(pos, dtype=torch.int32)
    want = pa.paged_decode_attention_plain(q, k, v, pt, p, window,
                                           logit_cap=cap)
    got = _split_decode(q, pa.gather_pages(k, pt), pa.gather_pages(v, pt),
                        p, window, chunk, splits, logit_cap=cap, paged=True)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * scale)


# --- the sampler's split over a cluster ------------------------------------


def _better(a, ia, b, ib) -> bool:
    """sampling.cu's order: the larger value, ties to the smaller index,
    NaN above any number, the first NaN first."""
    na, nb = np.isnan(a), np.isnan(b)
    if na or nb:
        return bool(na and (not nb or ia < ib))
    return bool(a > b or (a == b and ia < ib))


def _split_argmax(x: np.ndarray, blocks: int, head: int) -> int:
    """sampling.cu's partition of one row of scores: ``head`` scalars before
    the first 16-byte boundary (block 0), the whole 4-element pieces in
    ``blocks`` contiguous slices, the scalars after them (the last block);
    each block's (best, index) and then the cluster's, under ``_better``."""
    V = x.shape[0]
    head = min(V, head)
    npieces = (V - head) // 4
    tail = head + 4 * npieces
    parts = []
    for r in range(blocks):
        idx = list(range(head + 4 * (npieces * r // blocks),
                         head + 4 * (npieces * (r + 1) // blocks)))
        if r == 0:
            idx = list(range(head)) + idx
        if r == blocks - 1:
            idx += list(range(tail, V))
        best, bi = -np.inf, 2 ** 31 - 1
        for i in idx:
            if _better(x[i], i, best, bi):
                best, bi = x[i], i
        parts.append((best, bi))
    best, bi = -np.inf, 2 ** 31 - 1
    for pb, pi in parts:
        if _better(pb, pi, best, bi):
            best, bi = pb, pi
    return bi


@pytest.mark.parametrize("V,blocks,head", [
    (4096, 16, 0), (4099, 7, 3), (1000, 1, 2), (31, 1, 1), (9, 4, 0),
    (5, 3, 3)])
def test_split_argmax_is_torch_argmax(V, blocks, head):
    """The sampler's split of a row over a cluster picks torch.argmax's
    index (the plain version's rule) whatever the slices: ties and NaNs
    whose occurrences fall in different blocks, a row of -inf, blocks with
    no piece."""
    rng = np.random.default_rng(V + blocks)
    rows = []
    x = rng.standard_normal(V).astype(np.float32)
    x[[V // 5, V - 1]] = 9.0                   # a tie across blocks
    rows.append(x)
    x = rng.standard_normal(V).astype(np.float32)
    x[[V // 2, V // 4, V - 2]] = np.nan        # the first NaN wins
    rows.append(x)
    rows.append(np.full(V, -np.inf, np.float32))
    for x in rows:
        want = int(torch.argmax(torch.from_numpy(x)))
        assert _split_argmax(x, blocks, head) == want


@pytest.mark.parametrize("B,V,sms,want", [
    (8, 128256, 132, 16),     # the smoke's rows: 16 blocks a row
    (64, 128256, 132, 3),     # B * 3 >= 132
    (1, 128256, 132, 16),     # the cluster's limit
    (8, 31, 132, 1),          # a short vocab runs as a cluster of one
    (8, 1000, 132, 1),
    (8, 4096, 132, 2),        # one block per THREADS 16-byte pieces
    (200, 128256, 132, 1),    # more rows than SMs
    (0, 128256, 132, 16),
])
def test_sample_cluster_blocks(B, V, sms, want):
    assert sm.cluster_blocks(B, V, sms) == want


def test_sample_launcher_marshals_arguments(monkeypatch):
    """``launch_cuda``'s argument order: THREADS and the cluster size
    ``cluster_blocks`` gives for the card's SM count, then the stream; a
    stand-in for ``csrc/sampling.cu::fused_sample`` writes the plain
    tokens, and a CUDA error raises."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(sm, "sm_count", lambda dev: 132)
    lg = torch.from_numpy(_logits(3, 4, 9000))
    temps = torch.tensor([0.0, 0.5, 1.0, 0.0])
    key = torch.tensor([7, 9], dtype=torch.int64)
    seen = {}

    def fake(lg_p, t_p, k_p, out_p, B, V, threads, blocks, stream):
        seen.update(ptrs=(lg_p, t_p, k_p), dims=(B, V), threads=threads,
                    blocks=blocks)
        out = torch.from_numpy(np.ctypeslib.as_array(
            (ctypes.c_int32 * B).from_address(out_p)))
        out.copy_(sm.fused_sample_plain(lg, temps, key))
        return 0

    got = sm.launch_cuda(fake, lg, temps, key)
    assert seen == dict(ptrs=(lg.data_ptr(), temps.data_ptr(),
                              key.data_ptr()), dims=(4, 9000),
                        threads=sm.THREADS, blocks=4)
    assert torch.equal(got, sm.fused_sample_plain(lg, temps, key))
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        sm.launch_cuda(lambda *a: 1, lg, temps, key)


# --- the launchers, through stand-ins for the compiled functions -----------


class _Stream:
    cuda_stream = 0


def _f32_at(ptr: int, n: int) -> torch.Tensor:
    """n float32 values at address ``ptr``, as a tensor sharing them."""
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctypes.c_float * n).from_address(ptr)))


def test_decode_launcher_marshals_arguments(monkeypatch):
    """``launch_cuda``'s argument order, scale and output allocation: a
    stand-in for ``csrc/decode_attention.cu::decode_attention`` reads the
    tensors back from the pointers it is given, writes the new rows and
    the plain attention into them, and the wrapper returns that output."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    B, H, K, L, hd, window, cap = 3, 8, 2, 40, 96, 11, 30.0
    pairs, (_, pos) = _decode_setup(12, B, H, K, L, hd, "float32")
    (_, q), (_, k), (_, v), (_, nk), (_, nv) = pairs
    kp, vp = k.clone(), v.clone()
    want = da.decode_attention_fused_plain(q, kp, vp, nk, nv, pos, window,
                                           logit_cap=cap)
    seen = {}

    def fake(dtype, q_p, k_p, v_p, nk_p, nv_p, pos_p, out_p, B_, H_, K_, L_,
             hd_, window_, scale, cap_, stream):
        seen.update(dtype=dtype, dims=(B_, H_, K_, L_, hd_), window=window_,
                    scale=scale, cap=cap_, fused=nk_p is not None)
        ptrs = (q_p, k_p, v_p, nk_p, nv_p, pos_p)
        assert ptrs == tuple(t.data_ptr() for t in (q, k, v, nk, nv, pos))
        qq = _f32_at(q_p, B_ * H_ * hd_).view(B_, H_, hd_)
        kk, vv = (_f32_at(x, B_ * L_ * K_ * hd_).view(B_, L_, K_, hd_)
                  for x in (k_p, v_p))
        nkk, nvv = (_f32_at(x, B_ * K_ * hd_).view(B_, K_, hd_)
                    for x in (nk_p, nv_p))
        _f32_at(out_p, B_ * H_ * hd_).view(B_, H_, hd_).copy_(
            da.decode_attention_fused_plain(qq, kk, vv, nkk, nvv, pos,
                                            window_, logit_cap=cap_))
        return 0

    got = da.launch_cuda(fake, q, k, v, nk, nv, pos, window, cap)
    assert seen == dict(dtype=0, dims=(B, H, K, L, hd), window=window,
                        scale=pytest.approx(hd ** -0.5), cap=cap, fused=True)
    assert torch.equal(got, want)
    assert torch.equal(k, kp) and torch.equal(v, vp)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        da.launch_cuda(lambda *a: 9, q, k, v, None, None, pos, 0, 0.0)


def test_flash_launcher_marshals_strides(monkeypatch):
    """``launch_cuda``'s strides and outputs on the model's transposed
    (B, S, H, hd) views: a stand-in for ``csrc/flash_attention.cu``
    rebuilds q, k, v and o from pointers and element strides, writes the
    plain attention and lse with the query offset, valid-key length and
    ``p_bf16`` it was given, and the wrapper returns o with q's strides."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    B, H, K, S, hd = 2, 4, 2, 24, 16
    rng = np.random.default_rng(13)

    def model_view(n):
        x = rng.standard_normal((B, S, n, hd)).astype(np.float32)
        return torch.from_numpy(x).transpose(1, 2)

    q, k, v = model_view(H), model_view(K), model_view(K)
    want, want_lse = fa.flash_attention_plain(q, k, v, causal=True,
                                              window=7, logit_cap=20.0)

    def fake(dtype, q_p, k_p, v_p, o_p, lse_p, B_, H_, K_, Sq, Skv, hd_,
             *rest):
        strides, (causal, window, q_off, kv_len, p_bf16, scale, cap,
                  stream) = rest[:12], rest[12:]
        assert dtype == 0 and scale == pytest.approx(hd_ ** -0.5)
        assert p_bf16 in (0, 1)

        def view(ptr, n, st):
            return _f32_at(ptr, B_ * S * n * hd_).as_strided(
                (B_, n, S, hd_), (*st, 1))
        qq, kk, vv, oo = (view(p, n, strides[3 * i:3 * i + 3]) for i, (p, n)
                          in enumerate(((q_p, H_), (k_p, K_), (v_p, K_),
                                        (o_p, H_))))
        o, lse = fa.flash_attention_plain(qq, kk, vv, causal=bool(causal),
                                          window=window, logit_cap=cap,
                                          q_offset=q_off, kv_len=kv_len,
                                          p_bf16=bool(p_bf16))
        oo.copy_(o)
        _f32_at(lse_p, B_ * H_ * Sq).view(B_, H_, Sq).copy_(lse)
        return 0

    got, lse = fa.launch_cuda(fake, q, k, v, True, 7, 20.0)
    assert got.stride() == q.stride()
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    want, want_lse = fa.flash_attention_plain(
        q, k, v, causal=True, window=7, logit_cap=20.0, q_offset=3,
        kv_len=22, p_bf16=True)
    got, lse = fa.launch_cuda(fake, q, k, v, True, 7, 20.0, q_offset=3,
                              kv_len=22, p_bf16=True)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        fa.launch_cuda(lambda *a: 700, q, k, v, True, 0, 0.0)


@pytest.mark.parametrize("source,name,argtypes", [
    ("decode_attention", "decode_attention", da.ARGTYPES),
    ("flash_attention", "flash_attention", fa.ARGTYPES),
    ("paged_attention", "paged_decode_attention", pa.ARGTYPES),
    ("sampling", "fused_sample", sm.ARGTYPES),
])
def test_attention_c_interfaces_match_the_ctypes_declarations(source, name,
                                                              argtypes):
    """Each ``extern "C"`` attention and sampling entry point takes as many
    arguments, pointers where pointers, as its ``ARGTYPES`` declares
    (ctypes cannot check it)."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
    params = [x.strip() for x in m.group(1).split(",")]
    assert len(params) == len(argtypes)
    assert ["*" in x for x in params] == \
        [t is ctypes.c_void_p for t in argtypes]
