"""The port's kernels (``repro_torch.kernels``) against the JAX package's
Pallas kernels (interpret mode) and oracles, on the CPU.

On CPU tensors the port's wrappers take the kernels' plain versions, so
these tests pin the plain versions — the CUDA kernels' oracles — to the
JAX reference, and pin what the wrappers do around the kernels: argument
checks, device dispatch, launch counting and the build's error path.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as da
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
    assert ops.launches == {"decode_attention": 0, "fused_sample": 0,
                            "cache_sim": 0, "cache_sim_ladder": 0}


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
        "cache_sim.cu", "decode_attention.cu", "sampling.cu"]
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_DEFAULT", tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
