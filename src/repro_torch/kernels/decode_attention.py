"""Decode attention for the serve tick: plain PyTorch version + CUDA launcher.

Replaces ``repro/kernels/decode_attention.py::_decode_kernel`` (reached
through ``decode_attention`` and ``decode_attention_fused``).  One query
row per slot attends that slot's cache prefix ``k_idx <= pos[b]``, inside
its local window when ``window > 0``; the fused variant first writes the
new token's K/V row at ``pos[b]``.  The CUDA kernel is
``csrc/decode_attention.cu`` on the body it shares with the paged kernel
(``csrc/split_decode.cuh``): the keys of a row are split into chunks of
32-256 keys over a cluster of up to 8 blocks whose partial softmax states
combine in the same launch; its design note says what bounds it.

Layouts (cache-native, as in the JAX package):
  q (B, H, hd); k/v cache (B, L, K, hd); new k/v rows (B, K, hd);
  pos (B,) int; window int (<= 0 = global) -> o (B, H, hd).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.launch.graph_analysis import tensor_bytes

NEG_INF = -2.0e38
HEAD_DIMS = (16, 32, 64, 96, 128, 256)   # every head_dim of the configs
MAX_GROUP = 32          # q heads of a kv group (their q and acc in smem)


def decode_attention_plain(q, k, v, pos, window=0, *, logit_cap=0.0):
    """Full (B, H, L) logits, plain softmax — the kernel's oracle, in the
    arithmetic of ``repro.kernels.ref.decode_attention_ref``."""
    B, H, hd = q.shape
    L, K = k.shape[1], k.shape[2]
    G = H // K
    qr = q.reshape(B, K, G, hd).float() * hd ** -0.5
    s = torch.einsum("bkgh,btkh->bkgt", qr, k.float())
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    k_idx = torch.arange(L, device=q.device)
    pos = pos.long()
    ok = k_idx[None, :] <= pos[:, None]
    if window > 0:
        ok &= k_idx[None, :] > pos[:, None] - window
    s = torch.where(ok[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkh->bkgh", p, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_fused_plain(q, k, v, new_k, new_v, pos, window=0, *,
                                 logit_cap=0.0):
    """Write ``new_k/new_v`` at each row's ``pos[b]`` IN PLACE, then attend.
    Every other cache row keeps its bits."""
    rows = torch.arange(q.shape[0], device=q.device)
    k[rows, pos.long()] = new_k
    v[rows, pos.long()] = new_v
    return decode_attention_plain(q, k, v, pos, window, logit_cap=logit_cap)


def traffic(q, k, v, pos, new_k=None, new_v=None):
    """(flops, bytes) of one call: the plain version's two products over
    all L keys of every row; each input read once, the output (like q)
    written once, and a fused new row read and written (2 x the row)."""
    B, H, hd = q.shape
    return (4.0 * B * H * k.shape[1] * hd,
            tensor_bytes(q, k, v, pos, q) + 2 * tensor_bytes(new_k, new_v))


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_args(q, k, v, new_k, new_v, pos, window):
    """Validate what the kernel takes; raises ValueError on anything else."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,hd), k/v (B,L,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    Bk, L, K, hdk = k.shape
    if Bk != B or hdk != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not fit cache "
                         f"{tuple(k.shape)}")
    if H // K > MAX_GROUP or hd not in HEAD_DIMS:
        raise ValueError(f"group {H // K} > {MAX_GROUP} or head_dim {hd} "
                         f"not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if new_k is not None:
        for t in (new_k, new_v):
            if t.shape != (B, K, hd) or t.dtype != q.dtype \
                    or not t.is_contiguous():
                raise ValueError(f"new k/v must be contiguous (B,K,hd) "
                                 f"{q.dtype}; got {tuple(t.shape)} "
                                 f"{t.dtype}")
    if pos.shape != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be (B,) int32; got {tuple(pos.shape)} "
                         f"{pos.dtype}")
    if not isinstance(window, int):
        raise ValueError(f"window must be a python int, got {type(window)}")
    for t in (q, k, v, pos):
        if not t.is_contiguous():
            raise ValueError("q, k, v and pos must be contiguous")
    # 16-byte copies of K/V rows (cp.async) and of the new rows
    for t in (q, k, v) + ((new_k, new_v) if new_k is not None else ()):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v and the new rows must be 16-byte "
                             "aligned")


def launch_cuda(fn, q, k, v, new_k, new_v, pos, window, logit_cap):
    """Launch ``decode_attention`` from ``csrc/decode_attention.cu`` on the
    current stream.  ``new_k is None`` attends a cache that already holds
    the row.  Returns o (B, H, hd)."""
    B, H, hd = q.shape
    L, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    nk = new_k.data_ptr() if new_k is not None else None
    nv = new_v.data_ptr() if new_v is not None else None
    err = fn(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        nk, nv, pos.data_ptr(), out.data_ptr(), B, H, K, L, hd, window,
        float(hd ** -0.5), float(logit_cap),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err}")
    return out


ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
