"""Fused next-token sampling: plain PyTorch version + CUDA launcher.

Replaces ``repro/kernels/sampling.py::_sample_kernel`` (``fused_sample``).
Greedy rows (``temps[b] <= 0``) take the first-occurrence argmax of the raw
logits.  Temperature rows take the argmax of ``x / max(t, 1e-6) + g``, a
Gumbel-max draw from ``softmax(x / t)``, with ``g`` derived from a
murmur3-finalizer hash of (key words, flat index ``b*V + v``): given the
same two key words both versions here, and the JAX kernel, pick the same
tokens.  The CUDA kernel is ``csrc/sampling.cu``: each row is split over a
cluster of ``cluster_blocks(B, V, SMs)`` blocks that combine in the same
launch.

Layouts: logits (B, V) f32; temps (B,) f32; key (2,) int64 holding two
uint32 words -> (B,) int32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

M32 = 0xFFFFFFFF
THREADS = 512           # threads a block
MAX_CLUSTER = 16        # blocks a row: the H100's non-portable cluster size


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 ``h`` in [0, 2**32), split so that no
    int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = (h * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer in int64 arithmetic masked to 32 bits."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(B: int, V: int, key: torch.Tensor) -> torch.Tensor:
    """(B, V) f32 Gumbel noise of the counter hash for ``key`` (2,)."""
    key = key.long()
    ctr = torch.arange(B * V, dtype=torch.int64,
                       device=key.device).reshape(B, V) & M32
    bits = _fmix(_fmix(ctr ^ key[0]) ^ key[1])
    u = (bits >> 9).float() * 2.0 ** -23 + 2.0 ** -24      # u in (0, 1)
    return -torch.log(-torch.log(u))


def perturbed_logits(logits, temps, key) -> torch.Tensor:
    """The scores whose argmax is the token: raw logits on greedy rows,
    ``x / max(t, 1e-6) + g`` on temperature rows."""
    B, V = logits.shape
    x = logits.float()
    t = temps.float()[:, None]
    g = gumbel_noise(B, V, key)
    return torch.where(t > 0, x / torch.clamp_min(t, 1e-6) + g, x)


def fused_sample_plain(logits, temps, key) -> torch.Tensor:
    return torch.argmax(perturbed_logits(logits, temps, key),
                        dim=-1).to(torch.int32)


def check_args(logits, temps, key):
    if logits.ndim != 2 or logits.dtype != torch.float32 \
            or not logits.is_contiguous():
        raise ValueError(f"logits must be contiguous (B,V) float32; got "
                         f"{tuple(logits.shape)} {logits.dtype}")
    B = logits.shape[0]
    if temps.shape != (B,) or temps.dtype != torch.float32 \
            or not temps.is_contiguous():
        raise ValueError(f"temps must be (B,) float32; got "
                         f"{tuple(temps.shape)} {temps.dtype}")
    if key.shape != (2,) or key.dtype != torch.int64 \
            or not key.is_contiguous():
        raise ValueError(f"key must be (2,) int64; got {tuple(key.shape)} "
                         f"{key.dtype}")


def cluster_blocks(B: int, V: int, sms: int) -> int:
    """Blocks that split each of ``B`` rows of ``V`` logits on a card of
    ``sms`` SMs: enough that the B rows cover the SMs, at most
    ``MAX_CLUSTER``, and at most one block per ``THREADS`` 16-byte pieces of
    a row, so that every thread of a block gets a piece (a short vocab runs
    as a cluster of one)."""
    per_row = -(-sms // max(B, 1))
    by_size = max(1, V // (4 * THREADS))
    return max(1, min(MAX_CLUSTER, per_row, by_size))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_cuda(fn, logits, temps, key):
    """Launch ``fused_sample`` from ``csrc/sampling.cu`` on the current
    stream.  Returns (B,) int32 tokens."""
    B, V = logits.shape
    out = torch.empty(B, dtype=torch.int32, device=logits.device)
    err = fn(
        logits.data_ptr(), temps.data_ptr(), key.data_ptr(), out.data_ptr(),
        B, V, THREADS, cluster_blocks(B, V, sm_count(logits.device)),
        torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_sample launch failed: CUDA error {err}")
    return out


ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
