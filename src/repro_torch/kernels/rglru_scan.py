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


def rglru_gated_scan_plain(x, r, i, lam, h0: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gates in f32 as the JAX package forms them, then the sequential
    recurrence: ``log_a = -8 softplus(lam) r``, ``a = exp(log_a)``, ``b =
    sqrt(1 - a^2) i x`` (``1 - a^2`` as ``-expm1(2 log_a)``, softplus as
    ``logaddexp(lam, 0)``).  Returns (y (B,S,R) in x's dtype, h_final (B,R)
    f32)."""
    lam = lam.float()
    log_a = -_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r.float()
    a = torch.exp(log_a)
    # sqrt(1 - a^2) computed stably via expm1
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    gated = beta * i.float() * x.float()
    y, h = rglru_scan_plain(a.contiguous(), gated.contiguous(),
                            h0.float().contiguous() if h0 is not None
                            else None)
    return y.to(x.dtype), h


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
