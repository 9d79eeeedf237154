"""Flash attention for the train forward: plain PyTorch version + CUDA launcher.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel`` (reached
through ``flash_attention``): causal, windowed or non-causal GQA attention
with a logit softcap, q head h reading kv head ``h // (H/K)``.  Beyond the
TPU kernel it also returns each row's log-sum-exp, the statistic the
backward recomputes the probabilities from, and it takes any Sq and Skv
(the ragged edge is masked inside the kernel) and any strides with a
contiguous last dimension.  The CUDA kernel is ``csrc/flash_attention.cu``
(bf16: TMA loads into a warp-specialised ``wgmma`` pipeline; f32: the
CUDA cores); its design note says what bounds it.

Layouts (the Pallas kernel's): q (B, H, Sq, hd); k/v (B, K, Skv, hd) ->
o (B, H, Sq, hd) in q's dtype, lse (B, H, Sq) f32.  ``window`` <= 0 is
global.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.launch.graph_analysis import tensor_bytes

NEG_INF = -2.0e38
HEAD_DIMS = (16, 32, 64, 96, 128, 256)   # every head_dim of the configs
MAX_GRID_YZ = 65535              # grid dims y and z: heads or q tiles, batch
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal=True, window=0, logit_cap=0.0):
    """O(S^2) attention in the arithmetic of
    ``repro.kernels.ref.flash_attention_ref`` (k/v repeated per q head, f32
    logits, finite NEG_INF mask, softmax), plus lse = m + log(max(l,
    1e-37)) as ``_flash_fwd_scan`` forms it.  Returns (o, lse)."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    kf = k.repeat_interleave(G, dim=1).float()
    vf = v.repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * hd ** -0.5, kf)
    if logit_cap:
        s = logit_cap * torch.tanh(s / logit_cap)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    ok = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window > 0:
        ok &= k_pos > q_pos - window
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    lse = m + torch.log(torch.clamp(l, min=1e-37))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
    return o, lse


def traffic(q, k, v):
    """(flops, bytes) of one call: the plain version's two products over
    every (query, key) pair; the inputs read once, o (like q) and the f32
    lse written once."""
    B, H, Sq, hd = q.shape
    return (4.0 * B * H * Sq * k.shape[2] * hd,
            tensor_bytes(q, k, v, q) + 4 * B * H * Sq)


def check_args(q, k, v, causal, window, logit_cap):
    """Validate what the kernel takes; raises ValueError on anything else."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,Sq,hd), k/v (B,K,Skv,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, hd = q.shape
    Bk, K, Skv, hdk = k.shape
    if Bk != B or hdk != hd or K < 1 or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not isinstance(causal, bool) or not isinstance(window, int) \
            or window < 0:
        raise ValueError(f"causal must be a bool and window an int >= 0; "
                         f"got {causal!r}, {window!r}")
    if Sq < 1 or Skv < 1 or H > MAX_GRID_YZ or B > MAX_GRID_YZ:
        raise ValueError(f"empty sequence or too many heads/batch rows: "
                         f"B={B} H={H} Sq={Sq} Skv={Skv}")
    if window > 0 and Sq >= Skv + window:
        # rows q >= Skv + window - 1 would attend no key at all
        raise ValueError(f"window {window} leaves query rows past "
                         f"{Skv + window - 2} with no key (Sq={Sq}, "
                         f"Skv={Skv})")
    vec = 16 // q.element_size()       # elements of one 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1 or any(s % vec for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name} needs a contiguous last dimension, "
                             f"strides that are multiples of {vec} elements "
                             f"and a 16-byte aligned start; got strides "
                             f"{t.stride()}")
    if not float(logit_cap) >= 0.0:
        raise ValueError(f"logit_cap must be >= 0, got {logit_cap}")


def launch_cuda(fn, q, k, v, causal, window, logit_cap):
    """Launch ``flash_attention`` from ``csrc/flash_attention.cu`` on the
    current stream.  The output takes q's strides (so a transposed view of
    a (B, S, H, hd) tensor gets a (B, S, H, hd) output behind it).
    Returns (o, lse)."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
             out.data_ptr(), lse.data_ptr(), B, H, K, Sq, Skv, hd, *strides,
             int(causal), window, float(hd ** -0.5), float(logit_cap),
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out, lse


ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
