"""Paged decode attention for the paged serve tick: plain PyTorch version +
CUDA launcher.

Replaces ``repro/kernels/paged_attention.py::_paged_kernel`` (reached
through ``paged_decode_attention`` and ``paged_decode_attention_fused``).
The KV cache is a shared physical page pool instead of one dense row per
slot: row b's logical key ``t`` lives at physical page
``page_table[b, t // ps]``, row ``t % ps``.  Query row b attends logical
keys ``[max(pos[b] - window + 1, 0), pos[b]]`` (``window <= 0`` = global);
the fused variant first writes the new token's K/V row at ``pos[b]``
through the page table, into the row's private boundary page.  The CUDA
kernel is ``csrc/paged_attention.cu``, the dense decode kernel's split-K
cluster body (``csrc/split_decode.cuh``) with a key's row found through
the page table; its design note says what bounds it.

Layouts (as in the JAX package):
  q (B, H, hd); k/v pools (P, ps, K, hd); page_table (B, nb) int32;
  pos (B,) int32; new k/v rows (B, K, hd); window int -> o (B, H, hd).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.decode_attention import (_DTYPE_CODE, HEAD_DIMS,
                                                  MAX_GROUP,
                                                  decode_attention_plain)
from repro_torch.launch.graph_analysis import tensor_bytes


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor):
    """Each row's pages as one linear cache: (P, ps, K, hd) pool, (B, nb)
    table -> (B, nb * ps, K, hd)."""
    B, nb = page_table.shape
    return pool[page_table.long()].reshape((B, nb * pool.shape[1])
                                           + tuple(pool.shape[2:]))


def paged_decode_attention_plain(q, k, v, page_table, pos, window=0, *,
                                 logit_cap=0.0):
    """Gather each row's pages into a linear cache, then the dense plain
    decode attention — the kernel's oracle, in the arithmetic of
    ``repro.kernels.ref.paged_decode_attention_ref``."""
    return decode_attention_plain(q, gather_pages(k, page_table),
                                  gather_pages(v, page_table), pos, window,
                                  logit_cap=logit_cap)


def write_rows(pool, rows, page_table, first_pos, valid=None, *,
               trash=None):
    """Write ``rows`` (B, S, K, hd) at logical positions ``first_pos[b] +
    s`` through the page table, IN PLACE: key ``t`` of row b goes to row
    ``t % ps`` of page ``page_table[b, t // ps]``.  A write before position
    0, past the table or where ``valid`` (B, S) is False goes to page
    ``trash`` when one is given (no host sync) and is skipped otherwise.
    Returns the (B, S) int64 positions."""
    ps, nb = pool.shape[1], page_table.shape[1]
    wp = first_pos.long()[:, None] + torch.arange(rows.shape[1],
                                                  device=rows.device)
    ok = (wp >= 0) & (wp < nb * ps)
    if valid is not None:
        ok &= valid
    page = page_table.long().gather(1, (wp // ps).clamp(0, nb - 1))
    rows = rows.to(pool.dtype)
    if trash is None:
        pool[page[ok], wp[ok] % ps] = rows[ok]
    else:
        page = torch.where(ok, page, torch.full_like(page, trash))
        pool[page, wp % ps] = rows
    return wp


def paged_decode_attention_fused_plain(q, k, v, new_k, new_v, page_table,
                                       pos, window=0, *, logit_cap=0.0):
    """Write ``new_k/new_v`` at each row's ``pos[b]`` through the page
    table IN PLACE (nothing where ``pos[b] // ps >= nb``, as the Pallas
    index map), then attend.  Every other pool row keeps its bits."""
    write_rows(k, new_k[:, None], page_table, pos)
    write_rows(v, new_v[:, None], page_table, pos)
    return paged_decode_attention_plain(q, k, v, page_table, pos, window,
                                        logit_cap=logit_cap)


def traffic(q, k, v, page_table, pos, new_k=None, new_v=None):
    """(flops, bytes) of one call: the plain version's two products over
    the nb x ps keys of every row's table; each input read once (the whole
    pools, as the JAX gather of pages reads them), the output (like q)
    written once, and a fused new row read and written (2 x the row)."""
    B, H, hd = q.shape
    keys = page_table.shape[1] * k.shape[1]
    return (4.0 * B * H * keys * hd,
            tensor_bytes(q, k, v, page_table, pos, q)
            + 2 * tensor_bytes(new_k, new_v))


def check_args(q, k, v, new_k, new_v, page_table, pos, window):
    """Validate what the kernel takes; raises ValueError on anything else."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,hd), k/v pools (P,ps,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    P, ps, K, hdk = k.shape
    if hdk != hd or H % K:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool "
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
    if page_table.ndim != 2 or page_table.shape[0] != B \
            or page_table.dtype != torch.int32:
        raise ValueError(f"page_table must be (B, nb) int32; got "
                         f"{tuple(page_table.shape)} {page_table.dtype}")
    if pos.shape != (B,) or pos.dtype != torch.int32:
        raise ValueError(f"pos must be (B,) int32; got {tuple(pos.shape)} "
                         f"{pos.dtype}")
    if not isinstance(window, int):
        raise ValueError(f"window must be a python int, got {type(window)}")
    for t in (q, k, v, page_table, pos):
        if not t.is_contiguous():
            raise ValueError("q, k, v, page_table and pos must be "
                             "contiguous")
    # 16-byte copies of K/V rows (cp.async) and of the new rows
    for t in (q, k, v) + ((new_k, new_v) if new_k is not None else ()):
        if t.data_ptr() % 16:
            raise ValueError("q, k, v and the new rows must be 16-byte "
                             "aligned")


def launch_cuda(fn, q, k, v, new_k, new_v, page_table, pos, window,
                logit_cap):
    """Launch ``paged_decode_attention`` from ``csrc/paged_attention.cu``
    on the current stream.  ``new_k is None`` attends a pool that already
    holds the row.  Returns o (B, H, hd)."""
    B, H, hd = q.shape
    P, ps, K = k.shape[0], k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    nk = new_k.data_ptr() if new_k is not None else None
    nv = new_v.data_ptr() if new_v is not None else None
    err = fn(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        nk, nv, page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        B, H, K, P, ps, page_table.shape[1], hd, window, float(hd ** -0.5),
        float(logit_cap), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    return out


ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
            + [ctypes.c_float] * 2 + [ctypes.c_void_p])
