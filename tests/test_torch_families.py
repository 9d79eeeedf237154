"""The port's ssm (mamba2) and hybrid (recurrentgemma) families against the
JAX package, on the CPU: the two scans' plain versions against the Pallas
kernels (interpret mode) and their oracles, the blocks and the model's
prefill/decode against JAX with the same weights
(``model.init(PRNGKey(0))`` through ``params_from_numpy``), and the serve
engines token for token against the JAX ``EngineReference`` on the cases
of ``tests/test_serve_families.py``.

Tolerances: the scans' plain versions are held to the JAX kernel tests'
bounds (``tests/test_kernels.py``: ssd f32 5e-4 / bf16 5e-2; rglru f32
1e-4 / bf16 3e-2); blocks, prefill and decode to 1e-4 in f32 (sums in
another order than XLA's; the RG-LRU recurrence is sequential here and
an associative scan there).  A torch mirror of the CUDA SSD kernels'
five stages is held to 2e-5 in f32 (the same sums in another grouping).
The CUDA launchers are driven through stand-ins for the compiled
functions, which check the arguments and write the plain results.
"""
import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import get_config as jget_config
from repro.configs import reduced as jreduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import build_model as jbuild_model
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.serve import EngineReference as JEngineReference
from repro.serve import mixed_requests as jmixed_requests
from repro.serve import run_staggered as jrun_staggered
from repro.serve import staggered_groups as jstaggered_groups
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import build_model, rglru, ssm
from repro_torch.models.api import StateBank
from repro_torch.models.common import subtree
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (Engine, EngineReference, Request,
                               mixed_requests, run_staggered,
                               staggered_groups)

ARCHS = ("mamba2-1.3b", "recurrentgemma-2b")
MAX_LEN = 40
SLOTS = 3
TOL = 1e-4


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@functools.lru_cache(maxsize=None)
def _models(arch):
    jcfg = jreduced(jget_config(arch), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch), dtype="float32")
    model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


# --- the SSD scan ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S,P,N,chunk", [
    (1, 2, 64, 16, 8, 16),
    (2, 4, 128, 32, 16, 32),
    (1, 1, 64, 64, 32, 64),   # single chunk
])
def test_ssd_scan_plain_matches_pallas_and_oracle(dtype, B, H, S, P, N,
                                                  chunk):
    """The plain version (model layout) against the Pallas kernel in
    interpret mode and ``ref.ssd_scan_ref`` (head-major layout) on the
    shapes and bounds of ``tests/test_kernels.py::test_ssd_scan_sweep``."""
    rng = np.random.default_rng(1)
    x = _rand(rng, (B, H, S, P))
    dt = np.log1p(np.exp(_rand(rng, (B, H, S))))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32) * 0.3
    dtA = dt * A[None, :, None]
    Bm, Cm = _rand(rng, (B, S, N)), _rand(rng, (B, S, N))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [_j(a, jd) for a in (x, dt, dtA, Bm, Cm)]
    pallas = jops.ssd_scan(*jargs, chunk=chunk)
    oracle = jref.ssd_scan_ref(*jargs)

    def model_layout(a):             # (B,H,S,...) -> (B,S,H,...)
        return _t(a, td).transpose(1, 2).contiguous()

    y, s = ssd.ssd_scan_plain(model_layout(jargs[0]), model_layout(jargs[1]),
                              model_layout(jargs[2]), _t(jargs[3], td),
                              _t(jargs[4], td), chunk=chunk)
    assert y.dtype == td and s.dtype == torch.float32
    assert s.shape == (B, H, P, N)
    tol = 5e-4 if dtype == "float32" else 5e-2
    got = y.transpose(1, 2)
    _close(got, pallas, tol)
    _close(got, oracle, tol)


@pytest.mark.parametrize("S,chunk", [(64, 16), (48, 48)])
def test_ssd_scan_plain_carries_a_nonzero_state(S, chunk):
    """With an initial state: y and the final state against the JAX
    ``ssd_chunked`` (model layout, f32)."""
    rng = np.random.default_rng(2)
    b, H, P, N = 2, 3, 8, 16
    x = _rand(rng, (b, S, H, P))
    dt = np.log1p(np.exp(_rand(rng, (b, S, H))))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32) * 0.3
    Bm, Cm = _rand(rng, (b, S, N)), _rand(rng, (b, S, N))
    s0 = _rand(rng, (b, H, P, N))
    jy, js = jssm.ssd_chunked(_j(x), _j(dt), _j(A), _j(Bm), _j(Cm), chunk,
                              initial_state=_j(s0))
    y, s = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(Bm), _t(Cm), chunk,
                           initial_state=_t(s0))
    _close(y, jy, 5e-4)
    _close(s, js, 5e-4)


def test_ssd_scan_chunk_must_divide_s():
    z = torch.zeros
    with pytest.raises(ValueError, match=r"chunk 24 must divide .* S = 64"):
        ssd.ssd_scan_plain(z(1, 64, 2, 4), z(1, 64, 2), z(1, 64, 2),
                           z(1, 64, 8), z(1, 64, 8), chunk=24)


def _ssd_stages(x, dt, dtA, Bm, Cm, chunk, s0=None, tile=64):
    """A torch mirror of ``csrc/ssd_scan.cu``'s five kernels, every chunk
    at once, in f32: (1) cum, the cumsum of dtA over each chunk; (2) CB =
    C.B^T once per (batch, chunk), shared by the heads; (3) each chunk's
    own state; (4) the states entering each chunk and the final state;
    (5) the output by row and column tiles of ``tile``, a tile below the
    diagonal with its decay factored through its last row m."""
    b, S, H, P = x.shape
    N, Q = Bm.shape[-1], chunk
    nc = S // Q
    xf = x.float().reshape(b, nc, Q, H, P)
    dtf = dt.float().reshape(b, nc, Q, H)
    Bf = Bm.float().reshape(b, nc, Q, N)
    Cf = Cm.float().reshape(b, nc, Q, N)
    cum = torch.cumsum(dtA.float().reshape(b, nc, Q, H), dim=2)      # (1)
    cb = torch.einsum("bcin,bcjn->bcij", Cf, Bf)                      # (2)
    w = torch.exp(cum[:, :, -1:] - cum) * dtf                         # (3)
    own = torch.einsum("bcjhp,bcjn->bchpn", xf * w[..., None], Bf)
    s = torch.zeros(b, H, P, N) if s0 is None else s0.float()         # (4)
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * torch.exp(cum[:, c, -1])[..., None, None] + own[:, c]
    ent = torch.stack(entering, dim=1)                    # (b, nc, H, P, N)
    y = torch.einsum("bcin,bchpn->bcihp", Cf, ent) \
        * torch.exp(cum)[..., None]                                   # (5)
    for i0 in range(0, Q, tile):
        ri = slice(i0, min(i0 + tile, Q))
        for j0 in range(0, i0 + 1, tile):
            rj = slice(j0, min(j0 + tile, Q))
            ci, cj = cum[:, :, ri], cum[:, :, rj]          # (b, nc, t, H)
            if j0 < i0:     # below the diagonal: through m, no masking
                cm = cj[:, :, -1:]
                wts = cb[:, :, ri, rj, None] \
                    * (torch.exp(cm - cj) * dtf[:, :, rj])[:, :, None]
                part = torch.einsum("bcijh,bcjhp->bcihp", wts, xf[:, :, rj])
                y[:, :, ri] += torch.exp(ci - cm)[..., None] * part
            else:           # the diagonal tile: exp only where j <= i
                li = ci[:, :, :, None] - cj[:, :, None]
                ii = torch.arange(i0, ri.stop)[:, None]
                jj = torch.arange(j0, rj.stop)[None, :]
                decay = torch.exp(torch.where((jj <= ii)[..., None], li,
                                              float("-inf")))
                wts = cb[:, :, ri, rj, None] * decay \
                    * dtf[:, :, rj][:, :, None]
                y[:, :, ri] += torch.einsum("bcijh,bcjhp->bcihp", wts,
                                            xf[:, :, rj])
    return y.reshape(b, S, H, P).to(x.dtype), s


@pytest.mark.parametrize("b,S,H,P,N,chunk,tile,with_s0", [
    (2, 64, 3, 8, 16, 16, 16, True),      # one tile a chunk, 4 chunks
    (1, 96, 2, 16, 8, 48, 8, False),      # 6 tiles a chunk
    (2, 60, 2, 8, 12, 20, 8, True),       # ragged tiles: 20 rows of 8
    (1, 11, 2, 4, 8, 11, 64, False),      # one 11-row chunk
])
def test_ssd_stage_mirror_matches_plain_and_jax(b, S, H, P, N, chunk, tile,
                                                with_s0):
    """The five-stage decomposition against ``ssd_scan_plain`` and the JAX
    ``ssd_chunked`` on the same inputs, y and the final state, f32 2e-5."""
    rng = np.random.default_rng(11)
    x = _rand(rng, (b, S, H, P))
    dt = np.log1p(np.exp(_rand(rng, (b, S, H))))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32) * 0.3
    Bm, Cm = _rand(rng, (b, S, N), 0.5), _rand(rng, (b, S, N), 0.5)
    s0 = _rand(rng, (b, H, P, N)) if with_s0 else None
    dtA = dt * A
    y, s = _ssd_stages(_t(x), _t(dt), _t(dtA), _t(Bm), _t(Cm), chunk,
                       None if s0 is None else _t(s0), tile=tile)
    py, ps = ssd.ssd_scan_plain(_t(x), _t(dt), _t(dtA), _t(Bm), _t(Cm),
                                chunk=chunk,
                                s0=None if s0 is None else _t(s0))
    jy, js = jssm.ssd_chunked(_j(x), _j(dt), _j(A), _j(Bm), _j(Cm), chunk,
                              initial_state=None if s0 is None else _j(s0))
    for want_y, want_s in ((py, ps), (jy, js)):
        _close(y, want_y, 2e-5)
        _close(s, want_s, 2e-5)


class _Stream:
    cuda_stream = 0


def _f32_at(ptr: int, n: int) -> torch.Tensor:
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctypes.c_float * n).from_address(ptr)))


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_ssd_launcher_marshals_arguments(monkeypatch, dtype, code):
    """``ssd_scan.launch_cuda``: the scratch sized by the C sizer for the
    dtype, the argument order of ``csrc/ssd_scan.cu::ssd_scan``, the stage
    times handed back; a stand-in writes the plain results, and a CUDA
    error raises."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    rng = np.random.default_rng(12)
    b, S, H, P, N, Q = 2, 32, 3, 8, 4, 16
    dt = np.log1p(np.exp(_rand(rng, (b, S, H))))
    args = [_t(a, dtype) for a in (_rand(rng, (b, S, H, P)), dt,
                                   dt * -0.5, _rand(rng, (b, S, N)),
                                   _rand(rng, (b, S, N)))]
    s0 = _t(_rand(rng, (b, H, P, N)))
    want = ssd.ssd_scan_plain(*args, chunk=Q, s0=s0)
    seen = {}

    def sizer(dcode, *dims):
        seen["sizer"] = (dcode, dims)
        return 1000

    def fake(dcode, x_p, dt_p, dtA_p, B_p, C_p, s0_p, y_p, s_p, sc_p,
             nbytes, *rest):
        dims, stage, stream = rest[:6], rest[6], rest[7]
        seen.update(dtype=dcode, dims=dims, nbytes=nbytes, s0=s0_p,
                    ptrs=(x_p, dt_p, dtA_p, B_p, C_p), stream=stream)
        if stage is not None:
            for k in range(len(ssd.STAGE_NAMES)):
                stage[k] = k + 0.5
        if dtype == torch.float32:
            _f32_at(y_p, b * S * H * P).copy_(want[0].flatten())
        _f32_at(s_p, b * H * P * N).copy_(want[1].flatten())
        return 0

    stage_ms = []
    y, s = ssd.launch_cuda((fake, sizer), *args, Q, s0, stage_ms=stage_ms)
    assert seen["sizer"] == (code, (b, S, H, P, N, Q))
    assert seen["dtype"] == code and seen["nbytes"] == 1000
    assert seen["dims"] == (b, S, H, P, N, Q) and seen["stream"] == 0
    assert seen["ptrs"] == tuple(a.data_ptr() for a in args)
    assert seen["s0"] == s0.data_ptr()
    assert stage_ms == [0.5, 1.5, 2.5, 3.5, 4.5]
    assert y.dtype == dtype and y.shape == args[0].shape
    assert torch.equal(s, want[1])
    if dtype == torch.float32:
        assert torch.equal(y, want[0])
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        ssd.launch_cuda((lambda *a: 7, sizer), *args, Q, None)


# --- the RG-LRU scan ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R,block,wt", [
    (1, 128, 128, 32, 64),
    (2, 256, 256, 64, 128),
    (1, 64, 512, 64, 512),
])
def test_rglru_scan_plain_matches_pallas_and_oracle(dtype, B, S, R, block,
                                                    wt):
    """On the shapes and bounds of ``tests/test_kernels.py::
    test_rglru_scan_sweep``: the inputs rounded to ``dtype`` as there, the
    plain version's f32 output against the Pallas kernel and
    ``ref.rglru_scan_ref``."""
    rng = np.random.default_rng(3)
    a = 1 / (1 + np.exp(-_rand(rng, (B, S, R))))
    b = _rand(rng, (B, S, R), 0.1)
    jd = getattr(jnp, dtype)
    ja, jb = _j(a, jd), _j(b, jd)
    pallas = jops.rglru_scan(ja, jb, block=block, width_tile=wt)
    oracle = jref.rglru_scan_ref(ja, jb)
    y, h = rg.rglru_scan_plain(_t(ja), _t(jb))
    assert y.dtype == torch.float32 and h.shape == (B, R)
    assert torch.equal(h, y[:, -1])
    tol = 1e-4 if dtype == "float32" else 3e-2
    _close(y.to(getattr(torch, dtype)), pallas, tol)
    _close(y.to(getattr(torch, dtype)), oracle, tol)


@pytest.mark.parametrize("S", [1, 40, 256, 512])
def test_rglru_model_scan_with_h0_matches_jax(S):
    """``models.rglru.rglru_scan`` (gates + recurrence) with h0 against the
    JAX ``rglru_scan``: its associative branch (S <= 256) and its blocked
    branch (S = 512)."""
    rng = np.random.default_rng(4)
    B, R = 2, 16
    x = _rand(rng, (B, S, R))
    r = 1 / (1 + np.exp(-_rand(rng, (B, S, R))))
    i = 1 / (1 + np.exp(-_rand(rng, (B, S, R))))
    lam = _rand(rng, (R,))
    h0 = _rand(rng, (B, R))
    jy, jh = jrglru.rglru_scan(_j(x), _j(r), _j(i), _j(lam), _j(h0))
    for impl in ("plain", "kernel"):
        y, h = rglru.rglru_scan(_t(x), _t(r), _t(i), _t(lam), _t(h0),
                                impl=impl)
        _close(y, jy)
        _close(h, jh)


@pytest.mark.parametrize("S", [1, 40, 256, 512])
def test_rglru_gated_scan_plain_matches_jax_model_scan(S):
    """``rglru_gated_scan_plain`` (the gate prologue the model ran before
    the recurrence, now the fused kernel's oracle) against the JAX model's
    ``rglru_scan`` with h0, at that test's bounds."""
    rng = np.random.default_rng(14)
    B, R = 3, 24
    x = _rand(rng, (B, S, R))
    r = 1 / (1 + np.exp(-_rand(rng, (B, S, R))))
    i = 1 / (1 + np.exp(-_rand(rng, (B, S, R))))
    lam = _rand(rng, (R,))
    h0 = _rand(rng, (B, R))
    jy, jh = jrglru.rglru_scan(_j(x), _j(r), _j(i), _j(lam), _j(h0))
    y, h = rg.rglru_gated_scan_plain(_t(x), _t(r), _t(i), _t(lam), _t(h0))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, jy)
    _close(h, jh)


def test_scan_ops_on_cpu_take_the_plain_versions_and_count_nothing():
    """``ops.ssd_scan``, ``ops.rglru_scan`` and ``ops.rglru_gated_scan`` on
    CPU tensors equal their plain versions bit for bit and count no
    launch."""
    rng = np.random.default_rng(15)
    ops.reset_launches()
    x, dt = _t(_rand(rng, (1, 32, 2, 8))), _t(np.abs(_rand(rng, (1, 32, 2))))
    Bm, Cm = _t(_rand(rng, (1, 32, 4))), _t(_rand(rng, (1, 32, 4)))
    got = ops.ssd_scan(x, dt, -dt, Bm, Cm, chunk=16)
    want = ssd.ssd_scan_plain(x, dt, -dt, Bm, Cm, chunk=16)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    a, bb = _t(rng.random((2, 9, 5))), _t(_rand(rng, (2, 9, 5)))
    got = ops.rglru_scan(a, bb)
    want = rg.rglru_scan_plain(a, bb)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    xs = [_t(_rand(rng, (2, 9, 5)), torch.bfloat16)] + [
        _t(1 / (1 + np.exp(-_rand(rng, (2, 9, 5)))), torch.bfloat16)
        for _ in range(2)]                # x, then the gates r and i
    lam, h0 = _t(_rand(rng, (5,)), torch.bfloat16), _t(_rand(rng, (2, 5)))
    got = ops.rglru_gated_scan(*xs, lam, h0)
    want = rg.rglru_gated_scan_plain(*xs, lam, h0)
    assert got[0].dtype == torch.bfloat16
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(v == 0 for v in ops.launches.values())


@pytest.mark.parametrize("B,R,sms,want", [
    (4, 2560, 132, 80),       # slice G's prefill: 128 blocks in one wave
    (8, 2560, 132, 160),      # its decode tick: 128 blocks
    (1, 2560, 132, 32),       # at least a warp's worth of chains
    (64, 2560, 132, 256),     # at most one chain a thread
    (3, 100, 132, 32),
])
def test_rglru_channels_per_block(B, R, sms, want):
    assert rg.channels_per_block(B, R, sms) == want
    assert want % 8 == 0


def test_rglru_gated_check_args():
    z = torch.zeros
    with pytest.raises(ValueError, match="share float32 or bfloat16"):
        rg.check_gated_args(z(2, 3, 4), z(2, 3, 4), z(2, 3, 4),
                            z(4, dtype=torch.bfloat16), None)
    with pytest.raises(ValueError, match="lam"):
        rg.check_gated_args(z(2, 3, 4), z(2, 3, 4), z(2, 3, 4), z(5), None)
    with pytest.raises(ValueError, match="h0"):
        rg.check_gated_args(z(2, 3, 4), z(2, 3, 4), z(2, 3, 4), z(4),
                            z(2, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        rg.check_gated_args(z(2, 4, 3).transpose(1, 2), z(2, 3, 4),
                            z(2, 3, 4), z(4), None)
    rg.check_gated_args(z(2, 3, 4), z(2, 3, 4), z(2, 3, 4), z(4), z(2, 4))


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_rglru_gated_launcher_marshals_arguments(monkeypatch, dtype, code):
    """``launch_gated_cuda``: the argument order of
    ``csrc/rglru_scan.cu::rglru_gated_scan``, the channels a block for the
    card's SM count; a stand-in writes the plain results, and a CUDA error
    raises."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    monkeypatch.setattr(rg, "sm_count", lambda dev: 132)
    rng = np.random.default_rng(16)
    B, S, R = 4, 5, 40
    xs = [_t(_rand(rng, (B, S, R)), dtype)] + [
        _t(1 / (1 + np.exp(-_rand(rng, (B, S, R)))), dtype)
        for _ in range(2)]                # x, then the gates r and i
    lam, h0 = _t(_rand(rng, (R,)), dtype), _t(_rand(rng, (B, R)))
    want = rg.rglru_gated_scan_plain(*xs, lam, h0)
    seen = {}

    def fake(dcode, x_p, r_p, i_p, lam_p, h0_p, y_p, h_p, B_, S_, R_, ch,
             stream):
        seen.update(dtype=dcode, dims=(B_, S_, R_), ch=ch, stream=stream,
                    ptrs=(x_p, r_p, i_p, lam_p, h0_p))
        _f32_at(h_p, B_ * R_).copy_(want[1].flatten())
        return 0

    y, h = rg.launch_gated_cuda(fake, *xs, lam, h0)
    assert seen == dict(dtype=code, dims=(B, S, R),
                        ch=rg.channels_per_block(B, R, 132), stream=0,
                        ptrs=tuple(t.data_ptr() for t in (*xs, lam, h0)))
    assert y.dtype == dtype and y.shape == (B, S, R)
    assert torch.equal(h, want[1])
    with pytest.raises(RuntimeError, match="CUDA error 3"):
        rg.launch_gated_cuda(lambda *a: 3, *xs, lam, None)


# --- blocks and the model ----------------------------------------------------


def _block_inputs(cfg, S, seed=5):
    return _rand(np.random.default_rng(seed), (2, S, cfg.d_model))


@pytest.mark.parametrize("S", [1, 12, 64])
def test_ssm_block_matches_jax(S):
    """Sequence branch (no state; S = 64 is two chunks) and, at S = 1 with
    a state, the recurrent decode branch."""
    jmodel, jparams, model, params = _models("mamba2-1.3b")
    cfg = model.cfg
    jp = {k[len("blocks/ssm/"):]: v[0] for k, v in jparams.items()
          if k.startswith("blocks/ssm/")}
    tp = {k: v[0] for k, v in subtree(params, "blocks/ssm").items()}
    u = _block_inputs(cfg, S)
    jstate = tstate = None
    if S == 1:
        rng = np.random.default_rng(6)
        c = jmodel.cache_defs(2, 8)
        conv = _rand(rng, c["conv"].shape[1:])
        s = _rand(rng, c["ssm"].shape[1:])
        jstate = {"conv": _j(conv), "ssm": _j(s)}
        tstate = {"conv": _t(conv), "ssm": _t(s)}
    jo, jst = jssm.ssm_block(jmodel.cfg, jp, _j(u), state=jstate)
    to, tst = ssm.ssm_block(cfg, tp, _t(u), state=tstate)
    _close(to, jo)
    if jst is not None:
        for n in ("conv", "ssm"):
            _close(tst[n], jst[n])


@pytest.mark.parametrize("S", [1, 12, 300])
def test_rglru_block_matches_jax(S):
    """Padded-conv branch without a state (S = 300: the JAX scan's blocked
    branch is not taken, 300 % 256 != 0) and the decode-window branch."""
    jmodel, jparams, model, params = _models("recurrentgemma-2b")
    cfg = model.cfg
    pre = "layer_0/rec/"
    jp = {k[len(pre):]: v for k, v in jparams.items() if k.startswith(pre)}
    tp = subtree(params, "layer_0/rec")
    u = _block_inputs(cfg, S)
    jstate = tstate = None
    if S == 1:
        rng = np.random.default_rng(7)
        h = _rand(rng, (2, cfg.lru_width))
        conv = _rand(rng, (2, 3, cfg.lru_width))
        jstate, tstate = ({"h": _j(h), "conv": _j(conv)},
                          {"h": _t(h), "conv": _t(conv)})
    jo, jst = jrglru.rglru_block(jmodel.cfg, jp, _j(u), state=jstate)
    to, tst = rglru.rglru_block(cfg, tp, _t(u), state=tstate)
    _close(to, jo)
    if jst is not None:
        for n in ("h", "conv"):
            _close(tst[n], jst[n])


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", [11, 64])
def test_prefill_logits_and_cache_match_jax(arch, S):
    jmodel, jparams, model, params = _models(arch)
    toks = _tokens(2, S)
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    assert set(tc) == set(jc)
    for n in jc:
        assert tc[n].dtype == getattr(torch, str(jc[n].dtype)), n
        _close(tc[n], jc[n])
    at = torch.tensor([S - 1, 3])
    tl_at, _ = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                             logits_at=at)
    _close(tl_at[:, 0], tl[torch.arange(2), at], 1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_vector_position_decode_matches_jax(arch, impl):
    """Per-row positions (rows at different depths), 12 ticks from a fresh
    cache: logits and every cache bank against JAX; the cache passed in
    keeps its bits."""
    jmodel, jparams, model, params = _models(arch)
    toks = _tokens(3, 12, seed=1)
    start = np.array([0, 5, 27], np.int32)
    jcache = jmodel.init_cache(3, MAX_LEN)
    cache = model.init_cache(3, MAX_LEN)
    for t in range(12):
        pos = start + t
        jl, jcache = jmodel.decode_step(
            jparams, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
            jnp.asarray(pos))
        before = {n: c.clone() for n, c in cache.items()}
        tl, new = model.decode_step(
            params, cache, {"tokens": torch.from_numpy(toks[:, t:t + 1])},
            torch.from_numpy(pos), attn_impl=impl)
        assert all(torch.equal(cache[n], before[n]) for n in cache)
        cache = new
        _close(tl, jl)
    assert set(cache) == set(jcache)
    for n in jcache:
        _close(cache[n], jcache[n])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_per_token_decode(arch):
    """``Model.prefill`` over S = 64 (two 32-token SSD chunks for mamba2)
    against the per-token ``decode_step`` loop: last-position logits and
    the final recurrent state within 2e-3, the JAX decode-vs-forward bound
    (``tests/test_models.py``)."""
    _, _, model, params = _models(arch)
    toks = torch.from_numpy(_tokens(2, 64, seed=2))
    lg, pc = model.prefill(params, {"tokens": toks})
    cache = model.init_cache(2, 64)
    for t in range(64):
        dl, cache = model.decode_step(
            params, cache, {"tokens": toks[:, t:t + 1]},
            torch.full((2,), t, dtype=torch.int32), attn_impl="kernel")
    _close(dl[:, 0], lg[:, -1], 2e-3)
    name = "ssm" if arch == "mamba2-1.3b" else "rec/h"
    _close(cache[name], pc[name], 2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_state_banks_key_exactly_like_the_cache(arch):
    _, _, model, _ = _models(arch)
    banks = model.state_banks()
    defs = model.cache_defs(SLOTS, 16)
    assert set(banks) == set(defs)
    for n, b in banks.items():
        assert isinstance(b, StateBank) and b.name == n
        assert defs[n].shape[b.batch_axis] == SLOTS
        assert b.kind in ("recurrent", "ring")
        if b.kind == "ring":
            assert b.seq_axis is not None and defs[n].shape[b.seq_axis] <= 16
    cache = model.init_cache(SLOTS, 16)
    if arch == "recurrentgemma-2b":
        assert cache["attn/pos"].dtype == torch.int32
        assert bool((cache["attn/pos"] == -1).all())
        assert cache["rec/h"].dtype == torch.float32
    else:
        assert cache["ssm"].dtype == torch.float32


def test_statebank_contract_validation():
    with pytest.raises(ValueError, match="kind"):
        StateBank("x", "paged", batch_axis=0)
    with pytest.raises(ValueError, match="batch_axis"):
        StateBank("x", "ring", batch_axis=2, seq_axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_jax_init_rules(arch):
    _, jparams, model, _ = _models(arch)
    params = model.init(torch.Generator().manual_seed(0))
    assert set(params) == set(jparams)
    consts = {"A_log": 0.0, "D_skip": 1.0, "lam": 1.0, "dt_bias": 0.0,
              "conv_b": 0.0}
    for n, p in params.items():
        assert tuple(p.shape) == jparams[n].shape, n
        leaf = n.rsplit("/", 1)[-1]
        if leaf in consts:
            assert bool((p == consts[leaf]).all()), n


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_and_page_table_refused(arch):
    _, _, model, params = _models(arch)
    with pytest.raises(ValueError, match="not supported"):
        model.paged_cache_defs(9, 8)
    with pytest.raises(ValueError, match="recurrent state"):
        model.decode_step(params, model.init_cache(1, 8),
                          {"tokens": torch.zeros(1, 1, dtype=torch.int32)},
                          torch.zeros(1, dtype=torch.int32),
                          page_table=torch.zeros(1, 1, dtype=torch.int32))


# --- serving -----------------------------------------------------------------


def _workload(seed=5, n=6):
    return mixed_requests(n, seed=seed, vocab=512, prompt_lens=(2, 9),
                          max_new=(2, 8))


@functools.lru_cache(maxsize=None)
def _jax_reference(arch):
    """The JAX EngineReference on ``tests/test_serve_families.py``'s
    staggered, uneven workload, with its eos probe."""
    jmodel, jparams, _, _ = _models(arch)

    def work():
        return jmixed_requests(6, seed=5, vocab=512, prompt_lens=(2, 9),
                               max_new=(2, 8))

    ref = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN)
    probe = jrun_staggered(ref, jstaggered_groups(work(), 2))
    eos = next(t for o in probe.values() for t in o[1:])
    ref = JEngineReference(jmodel, jparams, slots=SLOTS, max_len=MAX_LEN,
                           eos_id=eos)
    return probe, eos, jrun_staggered(ref, jstaggered_groups(work(), 2))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_reference_parity_vs_jax(arch):
    _, _, model, params = _models(arch)
    probe, eos, with_eos = _jax_reference(arch)
    assert any(o[-1] == eos and len(o) > 1 for o in with_eos.values()), \
        "workload must exercise an eos exit"
    for eos_id, want in ((None, probe), (eos, with_eos)):
        ref = EngineReference(model, params, slots=SLOTS, max_len=MAX_LEN,
                              eos_id=eos_id, device="cpu")
        assert run_staggered(ref, staggered_groups(_workload(), 2)) == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("K", [1, 4])
def test_engine_parity_vs_jax_staggered_uneven_eos(arch, K):
    """Staggered arrivals, uneven lengths, eos exits: the port's Engine
    emits the JAX reference's tokens, token for token."""
    _, _, model, params = _models(arch)
    _, eos, with_eos = _jax_reference(arch)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN, eos_id=eos,
                 ticks_per_sync=K, device="cpu")
    out = run_staggered(eng, staggered_groups(_workload(), 2))
    assert out == with_eos, f"{arch} K={K}"
    assert eng.counts["prefill_steps"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_guarded_rows_at_reset_after_a_drain(arch):
    """After every request drains, each guarded bank row sits at its reset
    value (-1 for the ring positions, 0 elsewhere)."""
    _, _, model, params = _models(arch)
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    for r in _workload(seed=3, n=5):
        eng.submit(r)
    assert eng.run() == 0
    assert eng._guarded == set(eng.cache)
    for n, c in eng.cache.items():
        assert bool((c == eng._bank_reset[n]).all()), n
    assert eng._bank_reset.get("attn/pos", -1) == -1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_scan_leaves_other_slots_bitwise(arch):
    """An admission's prefill scan writes the admitted slot's rows only:
    a slot mid-decode and a free slot keep their bits, and the mid-decode
    request ends as it would alone."""
    _, _, model, params = _models(arch)
    alone = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                   ticks_per_sync=2, device="cpu")
    ra = Request(uid=0, prompt=[5, 7, 11, 13], max_new_tokens=10)
    alone.submit(ra)
    alone.run()

    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    a = Request(uid=0, prompt=list(ra.prompt), max_new_tokens=10)
    eng.submit(a)
    eng.step()
    gen = torch.Generator().manual_seed(3)
    free = 2
    for c in eng.cache.values():        # noise in the free slot's rows
        row = c.narrow(1, free, 1)
        row.copy_(torch.randint(-5, 5, row.shape, generator=gen))
    before = {n: c.clone() for n, c in eng.cache.items()}
    eng.submit(Request(uid=1, prompt=[101, 102, 103], max_new_tokens=4))
    eng._admit()                                  # lands in slot 1
    for n, c in eng.cache.items():
        assert torch.equal(c[:, [0, 2]], before[n][:, [0, 2]]), n
        assert not torch.equal(c[:, 1], before[n][:, 1]), n
    eng.run()
    assert a.output == ra.output


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_launch_counts_on_cpu_stay_zero(arch):
    """On CPU tensors the wrappers take the plain versions and count no
    launch; the engine counts its prefill-scan steps."""
    _, _, model, params = _models(arch)
    ops.reset_launches()
    eng = Engine(model, params, slots=SLOTS, max_len=MAX_LEN,
                 ticks_per_sync=2, device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=3))
    eng.run()
    assert eng.counts["prefill_steps"] == 5
    assert all(v == 0 for v in ops.launches.values())
