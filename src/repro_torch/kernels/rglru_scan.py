"""RG-LRU linear recurrence: plain PyTorch version + CUDA launcher.

Replaces ``repro/kernels/rglru_scan.py::_rglru_kernel``
(``rglru_scan_kernel``): ``h_t = a_t * h_{t-1} + b_t`` along time, with
``a_t`` and ``b_t`` precomputed by the caller (the gate prologue stays in
``models/rglru.py``).  Beyond the TPU kernel it takes an initial state
``h0`` and returns the final one, which the recurrent decode tick and the
prefill need.  The CUDA kernel is ``csrc/rglru_scan.cu``; it rounds the
product and the sum separately, as this plain version does, so the two
agree bit for bit.

Layouts: a, b (B, S, R) f32; h0 (B, R) f32 or None (zero start) -> y (B,
S, R) f32 (every step's h) and h_final (B, R) f32.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

THREADS = 64      # channels per block: B * R / 64 blocks spread over the SMs


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


def check_args(a, b, h0):
    """Validate what the kernel takes; raises ValueError on anything else."""
    if a.ndim != 3 or b.shape != a.shape or min(a.shape) < 1:
        raise ValueError(f"want a, b (B,S,R) of one non-empty shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    B, _, R = a.shape
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a and b must be float32; got {a.dtype}, "
                         f"{b.dtype}")
    if h0 is not None and (h0.shape != (B, R) or h0.dtype != torch.float32
                           or not h0.is_contiguous()):
        raise ValueError(f"h0 must be contiguous (B,R) float32; got "
                         f"{tuple(h0.shape)} {h0.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")


def launch_cuda(fn, a, b, h0):
    """Launch ``rglru_scan`` from ``csrc/rglru_scan.cu`` on the current
    stream.  Returns (y (B,S,R) f32, h_final (B,R) f32)."""
    B, S, R = a.shape
    y = torch.empty_like(a)
    h_out = torch.empty((B, R), dtype=torch.float32, device=a.device)
    err = fn(a.data_ptr(), b.data_ptr(),
             h0.data_ptr() if h0 is not None else None, y.data_ptr(),
             h_out.data_ptr(), B, S, R, THREADS,
             torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return y, h_out


ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
