"""Workload memory-behavior profiles (paper §3.3) — engine views.

The paper obtains L2 read/write transaction counts from nvprof on a GTX
1080 Ti.  Here they are derived analytically from per-layer workload
descriptors.  The implementation lives in ``core.traffic``: workloads are
packed into padded descriptor arrays and the whole (workload x mode x
batch-grid) traffic tensor is computed in one batched, differentiable
call on the device.  This module keeps the paper-shaped public API:
``profile()`` / ``paper_profiles()`` / ``dl_profiles()`` are thin views
over one engine evaluation, and ``_layer_traffic`` is the float64 scalar
reference the engine is held against (1e-6 relative).

Traffic model (knobs in ``traffic.TRAFFIC``, calibrated against the
paper's §4 claims):

inference (batch B), per layer:
    reads  = B * in_bytes * k_im2col / r_L1          (fmap tiles via im2col)
           + W * (1 + B / W_TILE)                    (weights streamed to SMs)
    writes = B * out_bytes

training adds the backward pass: activations re-read for dW and dX,
weight-gradient accumulation read-modify-write per GRAD_TILE samples.
This reproduces the paper's measured characteristics: per-workload R/W in
the Fig-3 range [2, 26], inference R/W decreasing and training R/W
increasing with batch size (§4.1, Fig 6).  DRAM transaction counts come
from the calibrated DRAM:L2 fractions (core/dram.py models their scaling
with capacity).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List

import torch

from repro_torch.core.constants import LINE_BYTES
from repro_torch.core.traffic import (MemoryProfile, TRAFFIC,
                                      compute_traffic, paper_pack)
from repro_torch.core.workloads import HPCG, NETWORKS, Network
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["MemoryProfile", "TRAFFIC", "profile", "profile_reference",
           "paper_profiles", "dl_profiles"]


def _layer_traffic(net: Network, batch: int, training: bool, t=None):
    """Scalar float64 reference: the engine's parity oracle.  Keep in sync
    with ``traffic._traffic``."""
    t = t or TRAFFIC
    reads = writes = 0.0
    for l in net.layers:
        k_eff = (t["k_im2col"] * l.k * l.k if l.kind == "conv" else 1.0)
        a_in = l.in_bytes * k_eff
        W = l.weight_bytes * (t["fc_w_factor"] if l.kind == "fc" else 1.0)
        if training:
            reads += (2.0 * batch * a_in + batch * l.out_bytes
                      + W * (2.0 + batch / t["grad_tile"]))
            writes += (batch * (l.in_bytes + l.out_bytes)
                       + W * (1.0 + batch / (2 * t["grad_tile"])))
        else:
            reads += batch * a_in + W * (1.0 + batch / t["w_tile"])
            writes += batch * l.out_bytes
    return reads / LINE_BYTES, writes / LINE_BYTES


def _check_hpcg_args(name: str, mode: str, batch: int) -> None:
    if mode != "hpc":
        raise ValueError(
            f"{name} is an HPC workload: mode must be 'hpc', got {mode!r} "
            f"(HPCG has no inference/training split)")
    if batch != 1:
        raise ValueError(
            f"{name} is an HPC workload: batch must be 1, got {batch} "
            f"(HPCG traffic is batch-independent)")


def profile_reference(net_name: str, mode: str, batch: int,
                      t=None) -> MemoryProfile:
    """Per-point float64 scalar path: the parity oracle."""
    t = t or TRAFFIC
    if net_name in HPCG:
        _check_hpcg_args(net_name, mode, batch)
        w = HPCG[net_name]
        r, wr = w.transactions()
        return MemoryProfile(w.name, "hpc", 1, r, wr,
                             (r + wr) * t["dram_frac_i"])
    net = NETWORKS[net_name]
    training = mode == "training"
    r, w = _layer_traffic(net, batch, training, t)
    frac = t["dram_frac_t"] if training else t["dram_frac_i"]
    return MemoryProfile(net.name, mode, batch, r, w, (r + w) * frac)


def profile(net_name: str, mode: str, batch: int, t=None,
            device: DeviceLike = None) -> MemoryProfile:
    """One (workload, mode, batch) profile: a view over one engine cell.

    Raises ``ValueError`` for HPCG names with ``mode != "hpc"`` or
    ``batch != 1``."""
    if net_name in HPCG:
        _check_hpcg_args(net_name, mode, batch)
    tt = compute_traffic(paper_pack(), (float(batch),), t, device)
    return tt.profile(net_name, mode, batch)


def paper_profiles(inference_batch: int = 4, training_batch: int = 64,
                   device: DeviceLike = None) -> List[MemoryProfile]:
    """The paper's workload set: 5 DNNs x {I, T} + HPCG-{S,M,L} (§4.1),
    one batched engine evaluation over the whole set."""
    # the knob values join the cache key so in-place TRAFFIC edits
    # (calibration experiments) can never serve stale cached profiles,
    # and so does the device: a result computed on one device is never
    # served for another
    return list(_paper_profiles_cached(int(inference_batch),
                                       int(training_batch),
                                       tuple(TRAFFIC.values()),
                                       resolve_device(device)))


@lru_cache(maxsize=8)
def _paper_profiles_cached(inference_batch: int, training_batch: int,
                           _knobs, device: torch.device):
    batches = tuple(dict.fromkeys((float(inference_batch),
                                   float(training_batch))))
    tt = compute_traffic(paper_pack(), batches, device=device)
    out: List[MemoryProfile] = []
    for name in NETWORKS:
        out.append(tt.profile(name, "inference", inference_batch))
        out.append(tt.profile(name, "training", training_batch))
    for name in HPCG:
        out.append(tt.profile(name, "hpc", 1))
    return tuple(out)


def dl_profiles(inference_batch: int = 4, training_batch: int = 64,
                device: DeviceLike = None) -> List[MemoryProfile]:
    return [p for p in paper_profiles(inference_batch, training_batch,
                                      device)
            if p.mode != "hpc"]
