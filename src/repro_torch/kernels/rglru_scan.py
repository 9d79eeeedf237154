"""RG-LRU linear recurrence: plain PyTorch versions + CUDA launchers.

Replaces ``repro/kernels/rglru_scan.py::_rglru_kernel``
(``rglru_scan_kernel``): ``h_t = a_t * h_{t-1} + b_t`` along time, with
``a_t`` and ``b_t`` precomputed by the caller.  Beyond the TPU kernel it
takes an initial state ``h0`` and returns the final one, which the
recurrent decode tick and the prefill need.  The gated entry
(``rglru_gated_scan_plain``, the composition ``models/rglru.py`` ran
before the recurrence) forms a and b from the block's x, r, i and Lambda
in the same launch, so that an R layer's scan is one launch.  The CUDA
kernel is ``csrc/rglru_scan.cu``; it rounds each product and sum as these
plain versions do, so the two agree bit for bit.

Layouts: a, b (B, S, R) f32; x, r, i (B, S, R) and lam (R,) of one float
dtype; h0 (B, R) f32 or None (zero start) -> y (B, S, R) (f32 for the
plain entry, x's dtype for the gated one) and h_final (B, R) f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels.sampling import sm_count
from repro_torch.launch.graph_analysis import tensor_bytes

_C = 8.0
MAX_CHANNELS = 256    # one chain a thread of a 256-thread block
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def rglru_scan_plain(a, b, h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence of ``repro/kernels/ref.py::rglru_scan_ref``
    with h0 in and h_final out."""
    B, S, R = a.shape
    h = (torch.zeros((B, R), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    y = torch.empty((B, S, R), dtype=torch.float32, device=a.device)
    af, bf = a.float(), b.float()
    for t in range(S):
        h = af[:, t] * h + bf[:, t]
        y[:, t] = h
    return y, h


def _gates(x, r, i, lam):
    """(softplus(lam), log_a, a, beta, b) in f32, as the JAX package forms
    them: ``log_a = -8 softplus(lam) r``, ``a = exp(log_a)``, ``beta =
    sqrt(1 - a^2)`` (as ``sqrt(-expm1(2 log_a))``, stable), ``b = beta i
    x``; softplus as ``logaddexp(lam, 0)``."""
    lam = lam.float()
    sp = torch.logaddexp(lam, torch.zeros_like(lam))
    log_a = -_C * sp * r.float()
    a = torch.exp(log_a)
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    return sp, log_a, a, beta, beta * i.float() * x.float()


def rglru_gated_scan_plain(x, r, i, lam, h0: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gates in f32 as the JAX package forms them (``_gates``), then
    the sequential recurrence ``h_t = a_t h_{t-1} + b_t``.  Returns (y
    (B,S,R) in x's dtype, h_final (B,R) f32)."""
    _, _, a, _, gated = _gates(x, r, i, lam)
    y, h = rglru_scan_plain(a.contiguous(), gated.contiguous(),
                            h0.float().contiguous() if h0 is not None
                            else None)
    return y.to(x.dtype), h


def rglru_gated_scan_backward(scan, x, r, i, lam, h0, dy, dh):
    """Gradients (dx, dr, di, dlam, dh0) of the gated scan at (x, r, i,
    lam, h0) for upstream gradients dy (B,S,R) of y and dh (B,R) of
    h_final, with two runs of ``scan``, the ungated recurrence ``(a, b,
    h0) -> (h (B,S,R) f32, h_final)`` (``ops.rglru_scan``: the CUDA kernel
    on CUDA tensors):

    1. h in f32 again from the gates (the gated entry returned y in x's
       dtype, and the backward needs f32 ``h_{t-1}``);
    2. the adjoint ``g_t = dy_t + a_{t+1} g_{t+1}``, ``g_{S-1} = dy_{S-1}
       + dh``: the same recurrence reversed in time, run on flipped
       inputs whose first coefficient is 1, so that dh enters as the
       initial state;
    3. ``db_t = g_t``, ``da_t = g_t h_{t-1}`` (``h_{-1} = h0``), ``dh0 =
       a_0 g_0``, chained through the gates in f32.

    dh0 is None when h0 is.  The JAX package differentiates its blocked
    associative scan with XLA; the sums run in another order."""
    sp, log_a, a, beta, b = _gates(x, r, i, lam)
    h, _ = scan(a.contiguous(), b.contiguous(), h0)
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    g, _ = scan(a_next.flip(1).contiguous(), dy.float().flip(1).contiguous(),
                dh.float().contiguous())
    g = g.flip(1)
    start = (h0.float() if h0 is not None else torch.zeros_like(h[:, 0]))
    da = g * torch.cat([start[:, None], h[:, :-1]], dim=1)
    xf, i_f = x.float(), i.float()
    dbeta = g * i_f * xf
    # d beta / d log_a = -exp(2 log_a) / beta
    dlog_a = da * a - dbeta * torch.exp(2.0 * log_a) / beta
    dlam = (dlog_a * r.float()).sum((0, 1)) * (-_C) \
        * torch.sigmoid(lam.float())
    return ((g * beta * i_f).to(x.dtype), (dlog_a * (-_C * sp)).to(r.dtype),
            (g * beta * xf).to(i.dtype), dlam.to(lam.dtype),
            a[:, 0] * g[:, 0] if h0 is not None else None)


def traffic(a, b, h0=None):
    """(flops, bytes) of one ``rglru_scan`` call: no products; the inputs
    read once, the f32 y and final state written once."""
    B, S, R = a.shape
    return 0.0, tensor_bytes(a, b, h0) + 4 * (B * S * R + B * R)


def gated_traffic(x, r, i, lam, h0=None):
    """(flops, bytes) of one ``rglru_gated_scan`` call: no products; the
    inputs read once, y (like x) and the f32 final state written once."""
    B, S, R = x.shape
    return 0.0, tensor_bytes(x, r, i, lam, h0, x) + 4 * B * R


def channels_per_block(B: int, R: int, sms: int) -> int:
    """Channels (chains) of one block: the B * R chains cut into at most
    ``sms`` blocks where they fill them (each batch row into ``sms // B``
    tiles), a multiple of 8 in [32, ``MAX_CHANNELS``]."""
    tiles = max(1, sms // B)
    ch = -(-R // tiles)
    return max(32, min(MAX_CHANNELS, -(-ch // 8) * 8))


def _check_h0(h0, B, R):
    if h0 is not None and (h0.shape != (B, R) or h0.dtype != torch.float32
                           or not h0.is_contiguous()):
        raise ValueError(f"h0 must be contiguous (B,R) float32; got "
                         f"{tuple(h0.shape)} {h0.dtype}")


def check_args(a, b, h0):
    """Validate what the kernel takes; raises ValueError on anything else."""
    if a.ndim != 3 or b.shape != a.shape or min(a.shape) < 1:
        raise ValueError(f"want a, b (B,S,R) of one non-empty shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a and b must be float32; got {a.dtype}, "
                         f"{b.dtype}")
    _check_h0(h0, a.shape[0], a.shape[2])
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")


def check_gated_args(x, r, i, lam, h0):
    """Validate what the gated kernel takes; raises ValueError on anything
    else."""
    if x.ndim != 3 or r.shape != x.shape or i.shape != x.shape \
            or min(x.shape) < 1 or lam.shape != (x.shape[2],):
        raise ValueError(f"want x, r, i (B,S,R) of one non-empty shape and "
                         f"lam (R,); got {tuple(x.shape)}, {tuple(r.shape)}, "
                         f"{tuple(i.shape)}, {tuple(lam.shape)}")
    if x.dtype not in _DTYPE_CODE or any(t.dtype != x.dtype
                                         for t in (r, i, lam)):
        raise ValueError(f"x, r, i and lam must share float32 or bfloat16; "
                         f"got {[t.dtype for t in (x, r, i, lam)]}")
    _check_h0(h0, x.shape[0], x.shape[2])
    if not all(t.is_contiguous() for t in (x, r, i, lam)):
        raise ValueError("x, r, i and lam must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_cuda(fn, a, b, h0):
    """Launch ``rglru_scan`` from ``csrc/rglru_scan.cu`` on the current
    stream.  Returns (y (B,S,R) f32, h_final (B,R) f32)."""
    B, S, R = a.shape
    y = torch.empty_like(a)
    h_out = torch.empty((B, R), dtype=torch.float32, device=a.device)
    err = fn(a.data_ptr(), b.data_ptr(),
             h0.data_ptr() if h0 is not None else None, y.data_ptr(),
             h_out.data_ptr(), B, S, R,
             channels_per_block(B, R, sm_count(a.device)), _stream(a))
    if err:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return y, h_out


def launch_gated_cuda(fn, x, r, i, lam, h0):
    """Launch ``rglru_gated_scan`` from ``csrc/rglru_scan.cu`` on the
    current stream.  Returns (y (B,S,R) in x's dtype, h_final (B,R)
    f32)."""
    B, S, R = x.shape
    y = torch.empty_like(x)
    h_out = torch.empty((B, R), dtype=torch.float32, device=x.device)
    err = fn(_DTYPE_CODE[x.dtype], x.data_ptr(), r.data_ptr(), i.data_ptr(),
             lam.data_ptr(), h0.data_ptr() if h0 is not None else None,
             y.data_ptr(), h_out.data_ptr(), B, S, R,
             channels_per_block(B, R, sm_count(x.device)), _stream(x))
    if err:
        raise RuntimeError(f"rglru_gated_scan launch failed: CUDA error "
                           f"{err}")
    return y, h_out


ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
GATED_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
