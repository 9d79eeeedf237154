"""Mamba-2 SSD chunked scan: plain PyTorch version + CUDA launcher.

Replaces ``repro/kernels/ssd_scan.py::_ssd_kernel`` (``ssd_scan``).  Per
chunk of ``chunk`` rows, with ``cum`` the cumsum of ``dtA`` over the
chunk: the intra-chunk term ``sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j)
dt_j x_j``, the inter-chunk term ``exp(cum_i) (C_i . s)`` from the carried
(P, N) state, and the state update ``s = exp(cum_Q) s + sum_j exp(cum_Q -
cum_j) dt_j x_j B_j^T``; all in float32.  Beyond the TPU kernel it takes an
optional initial state and returns the final one, which the model's
prefill needs (the TPU kernel's zero start is ``s0=None``).  The CUDA
kernels are ``csrc/ssd_scan.cu``: one call is five launches
(``STAGE_NAMES``), chunk-parallel, with the products on the tensor cores.

Layouts are the model's (``repro/models/ssm.py::ssd_chunked``), not the
TPU kernel's head-major ones: x (b, S, H, P); dt, dtA (b, S, H); Bm, Cm
(b, S, N), all one float dtype; s0 (b, H, P, N) f32 or None -> y (b, S, H,
P) in x's dtype and the final state (b, H, P, N) f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

P_MAX, N_MAX = 64, 128        # what one CUDA block covers
CHUNK_MAX = 4096              # bounds the (b, S / chunk, chunk, chunk) C.B^T
STAGE_NAMES = ("cumsum", "cb", "chunk_state", "state_pass", "chunk_out")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_chunk(S: int, chunk: int) -> None:
    if chunk < 1 or S % chunk:
        raise ValueError(f"chunk {chunk} must divide the sequence length "
                         f"S = {S}")


def ssd_scan_plain(x, dt, dtA, Bm, Cm, *, chunk: int,
                   s0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One loop over chunks, f32 inside: ``ssd_chunked``'s body."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    check_chunk(S, chunk)
    s = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if s0 is None else s0.float())
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, :, :, None]
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        xf, dtf = x[:, sl].float(), dt[:, sl].float()
        Bf, Cf = Bm[:, sl].float(), Cm[:, sl].float()
        cum = torch.cumsum(dtA[:, sl].float(), dim=1)          # (b,Q,H)
        li = cum[:, :, None, :] - cum[:, None, :, :]            # (b,Q,Q,H)
        # mask before exp: exp of a positive cum_i - cum_j is never formed
        decay = torch.exp(torch.where(tri, li, float("-inf")))
        cb = torch.einsum("bin,bjn->bij", Cf, Bf)               # (b,Q,Q)
        w = cb[..., None] * decay * dtf[:, None, :, :]          # (b,Q,Q,H)
        y_diag = torch.einsum("bijh,bjhp->bihp", w, xf)
        y_off = torch.einsum("bin,bhpn->bihp", Cf, s) \
            * torch.exp(cum)[..., None]
        dstates = torch.exp(cum[:, -1:, :] - cum) * dtf          # (b,Q,H)
        s_inc = torch.einsum("bjn,bjhp->bhpn", Bf,
                             xf * dstates[..., None])
        s = s * torch.exp(cum[:, -1, :])[..., None, None] + s_inc
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), s


def check_args(x, dt, dtA, Bm, Cm, chunk, s0):
    """Validate what the kernel takes; raises ValueError on anything else."""
    if x.ndim != 4 or dt.ndim != 3 or Bm.ndim != 3:
        raise ValueError(f"want x (b,S,H,P), dt/dtA (b,S,H), B/C (b,S,N); "
                         f"got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(Bm.shape)}")
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    if dt.shape != (b, S, H) or dtA.shape != (b, S, H) \
            or Bm.shape != (b, S, N) or Cm.shape != (b, S, N):
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, dtA {tuple(dtA.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)}")
    check_chunk(S, chunk)
    if P > P_MAX or N > N_MAX or chunk > CHUNK_MAX:
        raise ValueError(f"the kernel takes P <= {P_MAX}, N <= {N_MAX}, "
                         f"chunk <= {CHUNK_MAX}; got P {P}, N {N}, chunk "
                         f"{chunk}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in (dt, dtA, Bm, Cm)):
        raise ValueError(f"x, dt, dtA, B, C must share float32 or bfloat16; "
                         f"got {[t.dtype for t in (x, dt, dtA, Bm, Cm)]}")
    if s0 is not None and (s0.shape != (b, H, P, N)
                           or s0.dtype != torch.float32
                           or not s0.is_contiguous()):
        raise ValueError(f"s0 must be contiguous (b,H,P,N) float32; got "
                         f"{tuple(s0.shape)} {s0.dtype}")
    if not all(t.is_contiguous() for t in (x, dt, dtA, Bm, Cm)):
        raise ValueError("x, dt, dtA, B and C must be contiguous")


def launch_cuda(fns, x, dt, dtA, Bm, Cm, chunk, s0,
                stage_ms: Optional[list] = None):
    """Run ``ssd_scan`` from ``csrc/ssd_scan.cu`` (``fns``: it and
    ``ssd_scan_scratch_bytes``) on the current stream, its scratch from
    ``torch.empty``.  With ``stage_ms`` (a list) the five kernels are timed
    between CUDA events and their ms appended in the order of
    ``STAGE_NAMES``.  Returns (y like x, final state (b,H,P,N) f32)."""
    run, scratch_bytes = fns
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    nbytes = scratch_bytes(_DTYPE_CODE[x.dtype], b, S, H, P, N, chunk)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    y = torch.empty_like(x)
    s_out = torch.empty((b, H, P, N), dtype=torch.float32, device=x.device)
    times = (ctypes.c_float * len(STAGE_NAMES))() \
        if stage_ms is not None else None
    err = run(_DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(),
              dtA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
              s0.data_ptr() if s0 is not None else None, y.data_ptr(),
              s_out.data_ptr(), scratch.data_ptr(), nbytes, b, S, H, P, N,
              chunk, times, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err}")
    if times is not None:
        stage_ms.extend(float(t) for t in times)
    return y, s_out


ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_longlong]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
SCRATCH_ARGTYPES = [ctypes.c_int] * 7
