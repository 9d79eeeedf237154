"""The port's CUDA kernels against their plain versions, on the card.

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


@pytest.mark.parametrize("V", [128256, 1000, 31])
def test_fused_sample_kernel_matches_plain(dev, V):
    B = 6
    g = torch.Generator(device=dev).manual_seed(1)
    logits = torch.randn(B, V, generator=g, device=dev) * 3
    logits[0, [1, V - 1]] = 90.0                       # first-occurrence tie
    temps = torch.tensor([0.0, -1.0, 0.5, 1.0, 2.0, 0.0], device=dev)
    key = torch.tensor([3, 0xFFFFFFFF], dtype=torch.int64, device=dev)
    got = ops.fused_sample(logits, temps, key)
    want = sm.fused_sample_plain(logits, temps, key)
    assert got.dtype == torch.int32 and int(got[0]) == 1
    greedy = temps <= 0
    assert torch.equal(got[greedy],
                       torch.argmax(logits, -1).to(torch.int32)[greedy])
    score = sm.perturbed_logits(logits, temps, key)
    rows = torch.arange(B, device=dev)
    gap = score[rows, want.long()] - score[rows, got.long()]
    assert float(gap.abs().max()) <= 1e-5 * float(score.abs().max())
