"""Batched differentiable workload-traffic engine.

One call computes the full **(workload x mode x batch-grid)** L2-read /
L2-write / DRAM transaction tensor for every packed workload on the device:
the paper's conv/fc layer stacks (``core.workloads``), HPCG, and the modern
``configs/`` models lowered through the ``LayerStack`` adapter.
``core.profiles.profile()`` / ``paper_profiles()`` are thin views over
this engine; ``core.iso`` and ``core.scaling`` consume whole traffic
tensors; ``make_claim_loss`` builds the §4 claim loss that autograd
differentiates in the six traffic knobs.

Array layout (fixed throughout):

    axis 0  W   workload            (order of ``WorkloadPack.names``)
    axis 1  2   mode                (``MODES`` = inference, training)
    axis 2  NB  batch grid          (order of the ``batches`` argument)

Workloads are packed as padded (W, Lmax) per-layer descriptor arrays
(``in_bytes``, ``out_bytes``, ``weight_bytes``, ``kk``, conv/fc masks,
valid mask).  Because every TRAFFIC knob factors out of the layer sum,
the pack also carries six exact float64 per-workload reductions
(``a_conv = sum_conv in*k^2``, ``a_fc``, ``s_in``, ``s_out``, ``w_conv``,
``w_fc``) computed once at pack time with numpy; the device path combines
them with the knobs in a handful of float32 ops, which keeps the batched
outputs within 1e-6 relative of the float64 scalar reference
(``profiles._layer_traffic``) while staying differentiable in all six
knobs.  HPCG rows carry fixed (reads, writes) counts, batch- and
mode-independent, and override the layer formulas via ``hpc_mask``.

The traffic model (paper §3.3):

    inference:  reads  = B*sum in*k_eff + W*(1 + B/w_tile)
                writes = B*sum out
    training:   reads  = 2B*sum in*k_eff + B*sum out + W*(2 + B/grad_tile)
                writes = B*sum(in + out) + W*(1 + B/(2*grad_tile))

with ``k_eff = k_im2col*k^2`` for conv layers, 1 for fc; fc weight streams
scaled by ``fc_w_factor``; everything divided by ``LINE_BYTES``.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.constants import LINE_BYTES
from repro_torch.core.workloads import HPCG, NETWORKS, HPCGWorkload, Network
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.roofline import dtype_bytes

# Traffic-model knobs, calibrated against the paper's §4 claims (Adam over
# the differentiable claim loss built by ``make_claim_loss``).
TRAFFIC = {
    # frozen calibration fit (mean |log err| 0.18 over the paper's 13
    # quantitative §4 claims; R/W range penalty 0)
    "k_im2col": 0.51713,   # net im2col amplification / L1 reuse (k^2/r_L1)
    "w_tile": 32.6899,     # samples per weight re-stream (inference)
    "grad_tile": 4.46882,  # samples per weight-grad accumulation RMW
    "fc_w_factor": 0.324592,  # FC weight streams are unit-stride/coalesced
    "dram_frac_i": 0.00848827,  # DRAM:L2 transaction ratio, inference
    "dram_frac_t": 0.00797266,  # DRAM:L2 transaction ratio, training
}

MODES = ("inference", "training")

# Modern-config cohort threaded through the Fig-3 / iso-capacity analyses.
MODERN_COHORT = ("llama3-8b", "mamba2-1.3b", "whisper-tiny")


@dataclasses.dataclass(frozen=True)
class MemoryProfile:
    """L2/DRAM transaction counts for one (workload, mode, batch)."""
    name: str
    mode: str            # "inference" | "training" | "hpc"
    batch: int
    l2_reads: float
    l2_writes: float
    dram: float          # DRAM transactions (at the 3MB baseline cache)

    @property
    def rw_ratio(self) -> float:
        return self.l2_reads / max(self.l2_writes, 1.0)

    @property
    def label(self) -> str:
        suffix = {"inference": "I", "training": "T", "hpc": ""}[self.mode]
        return f"{self.name}-{suffix}" if suffix else self.name


# ---------------------------------------------------------------------------
# Layer descriptors and the LayerStack adapter
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerDesc:
    """One layer's byte surfaces, as the traffic formulas see them.

    ``in_bytes`` / ``out_bytes`` are activation bytes per sample;
    ``weight_bytes`` is the streamed parameter surface; ``kk`` is the
    im2col k² amplification (1 for fc / pointwise layers)."""
    name: str
    kind: str            # "conv" | "fc"
    in_bytes: float
    out_bytes: float
    weight_bytes: float
    kk: float = 1.0


@dataclasses.dataclass(frozen=True)
class LayerStack:
    """A workload as a flat tuple of ``LayerDesc`` — the engine's unit.

    ``from_network`` lowers the paper's Table-3 conv/fc descriptors;
    ``from_config`` lowers a modern ``configs/`` model's per-layer byte
    surfaces (projection matrices, attention/scan state, activation
    tensors at ``seq_len`` tokens per sample, sized with the roofline
    dtype convention — ``launch.roofline.dtype_bytes``)."""
    name: str
    layers: Tuple[LayerDesc, ...]

    @classmethod
    def from_network(cls, net: Network) -> "LayerStack":
        descs = tuple(
            LayerDesc(l.name, l.kind, float(l.in_bytes), float(l.out_bytes),
                      float(l.weight_bytes),
                      float(l.k * l.k) if l.kind == "conv" else 1.0)
            for l in net.layers)
        return cls(net.name, descs)

    @classmethod
    def from_config(cls, cfg, seq_len: int = 4096) -> "LayerStack":
        return cls(cfg.arch, tuple(_lower_config(cfg, seq_len)))


def _fc_desc(name: str, tokens: int, d_in: int, d_out: int,
             db: int, weight_bytes: Optional[float] = None) -> LayerDesc:
    w = float(d_in * d_out * db) if weight_bytes is None else weight_bytes
    return LayerDesc(name, "fc", float(tokens * d_in * db),
                     float(tokens * d_out * db), w)


def _attn_desc(name: str, tokens: int, q_dim: int, kv_dim: int,
               db: int) -> LayerDesc:
    # weight-free mixing: reads Q plus the K/V surfaces, writes the context
    return LayerDesc(name, "fc", float(tokens * (q_dim + 2 * kv_dim) * db),
                     float(tokens * q_dim * db), 0.0)


def _lower_config(cfg, seq_len: int) -> List[LayerDesc]:
    """Per-layer byte surfaces of one modern ``ModelConfig``.

    First-order lowering: each projection matrix is an fc layer (tokens ×
    features activation surfaces, full weight matrix streamed — MoE
    streams only the ``top_k`` active experts); attention / SSM-scan
    mixing layers are weight-free with their state read as input surface.
    """
    db = dtype_bytes(cfg.dtype)
    tok = seq_len
    d = cfg.d_model
    out: List[LayerDesc] = []

    def attn_block(tag: str, kv_tokens: int = 0):
        q_dim = cfg.num_heads * cfg.head_dim
        kv_dim = cfg.num_kv_heads * cfg.head_dim
        out.append(_fc_desc(f"{tag}.qkv", tok, d, q_dim + 2 * kv_dim, db))
        out.append(_attn_desc(f"{tag}.mix", tok, q_dim, kv_dim, db))
        out.append(_fc_desc(f"{tag}.o", tok, q_dim, d, db))

    def mlp_block(tag: str):
        mlp_in = 2 * cfg.d_ff if cfg.gated_mlp else cfg.d_ff
        if cfg.is_moe:
            out.append(_fc_desc(f"{tag}.router", tok, d, cfg.num_experts, db))
            active = cfg.top_k * (d * mlp_in + cfg.d_ff * d) * db
            out.append(_fc_desc(f"{tag}.experts", tok, d, cfg.d_ff, db,
                                weight_bytes=float(active)))
            out.append(_fc_desc(f"{tag}.combine", tok, cfg.d_ff, d, db, 0.0))
        else:
            out.append(_fc_desc(f"{tag}.up", tok, d, mlp_in, db))
            out.append(_fc_desc(f"{tag}.down", tok, cfg.d_ff, d, db))

    def ssm_block(tag: str):
        d_in = cfg.ssm_expand * d
        d_xbc = d_in + 2 * cfg.ssm_state
        out.append(_fc_desc(f"{tag}.in", tok, d, d_in + d_xbc + cfg.ssm_heads,
                            db))
        # depthwise conv over the xBC stream (width = ssm_conv_width)
        out.append(LayerDesc(f"{tag}.conv", "conv",
                             float(tok * d_xbc * db), float(tok * d_xbc * db),
                             float(cfg.ssm_conv_width * d_xbc * db),
                             kk=float(cfg.ssm_conv_width)))
        # chunked scan: weight-free, reads xBC + recurrent state
        state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
        out.append(LayerDesc(f"{tag}.scan", "fc",
                             float((tok * d_xbc + state) * db),
                             float(tok * d_in * db), 0.0))
        out.append(_fc_desc(f"{tag}.out", tok, d_in, d, db))

    def rglru_block(tag: str):
        w = cfg.lru_width or d
        out.append(_fc_desc(f"{tag}.in", tok, d, 2 * w, db))
        out.append(LayerDesc(f"{tag}.scan", "fc", float(tok * 2 * w * db),
                             float(tok * w * db), float(4 * w * db)))
        out.append(_fc_desc(f"{tag}.out", tok, w, d, db))

    fam = cfg.family
    if fam == "encdec":
        for i in range(cfg.enc_layers):
            attn_block(f"enc{i}")
            mlp_block(f"enc{i}")
        for i in range(cfg.dec_layers):
            attn_block(f"dec{i}.self")
            attn_block(f"dec{i}.cross")
            mlp_block(f"dec{i}")
    elif fam == "ssm":
        for i in range(cfg.num_layers):
            ssm_block(f"l{i}")
    elif fam == "hybrid":
        pat = cfg.block_pattern or "A"
        for i in range(cfg.num_layers):
            if pat[i % len(pat)] == "A":
                attn_block(f"l{i}")
            else:
                rglru_block(f"l{i}")
            mlp_block(f"l{i}")
    else:  # dense | moe | vlm
        for i in range(cfg.num_layers):
            attn_block(f"l{i}")
            mlp_block(f"l{i}")
    out.append(_fc_desc("lm_head", tok, d, cfg.vocab_size, db))
    return out


# ---------------------------------------------------------------------------
# Workload packing
# ---------------------------------------------------------------------------

# padded per-layer descriptor fields, each an (W, Lmax) array in the pack
LAYER_FIELDS = ("in_bytes", "out_bytes", "weight_bytes", "kk",
                "is_conv", "is_fc", "mask")
# exact float64 per-workload reductions; all six TRAFFIC knobs factor out
# of the layer sum, so these are the engine's hot-path inputs
REDUCED_FIELDS = ("a_conv", "a_fc", "s_in", "s_out", "w_conv", "w_fc")


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: device cache
class WorkloadPack:
    """Padded descriptor arrays for a set of workloads (DESIGN.md §10)."""
    names: Tuple[str, ...]
    layers: Dict[str, np.ndarray]    # LAYER_FIELDS -> (W, Lmax) float64
    reduced: Dict[str, np.ndarray]   # REDUCED_FIELDS -> (W,) float64
    hpc_reads: np.ndarray            # (W,) fixed counts, 0 for DL rows
    hpc_writes: np.ndarray
    hpc_mask: np.ndarray             # (W,) bool

    def index(self, name: str) -> int:
        if name not in self.names:
            raise ValueError(f"{name!r} not in this pack (has {self.names})")
        return self.names.index(name)


def pack_workloads(stacks: Sequence[LayerStack],
                   hpc: Sequence[HPCGWorkload] = ()) -> WorkloadPack:
    """Pack layer stacks (+ fixed-count HPC workloads) into padded arrays."""
    w = len(stacks) + len(hpc)
    lmax = max([len(s.layers) for s in stacks] or [1])
    layers = {f: np.zeros((w, lmax)) for f in LAYER_FIELDS}
    for i, s in enumerate(stacks):
        for j, l in enumerate(s.layers):
            layers["in_bytes"][i, j] = l.in_bytes
            layers["out_bytes"][i, j] = l.out_bytes
            layers["weight_bytes"][i, j] = l.weight_bytes
            layers["kk"][i, j] = l.kk
            layers["is_conv"][i, j] = 1.0 if l.kind == "conv" else 0.0
            layers["is_fc"][i, j] = 1.0 if l.kind == "fc" else 0.0
            layers["mask"][i, j] = 1.0
    conv, fc, m = (layers["is_conv"], layers["is_fc"], layers["mask"])
    reduced = {
        "a_conv": (layers["in_bytes"] * layers["kk"] * conv * m).sum(1),
        "a_fc": (layers["in_bytes"] * fc * m).sum(1),
        "s_in": (layers["in_bytes"] * m).sum(1),
        "s_out": (layers["out_bytes"] * m).sum(1),
        "w_conv": (layers["weight_bytes"] * conv * m).sum(1),
        "w_fc": (layers["weight_bytes"] * fc * m).sum(1),
    }
    hpc_r = np.zeros(w)
    hpc_w = np.zeros(w)
    hpc_m = np.zeros(w, dtype=bool)
    names = [s.name for s in stacks]
    for k, wload in enumerate(hpc):
        i = len(stacks) + k
        r, wr = wload.transactions()
        hpc_r[i], hpc_w[i], hpc_m[i] = r, wr, True
        names.append(wload.name)
    return WorkloadPack(tuple(names), layers, reduced, hpc_r, hpc_w, hpc_m)


@lru_cache(maxsize=None)
def paper_pack() -> WorkloadPack:
    """The paper's workload set: 5 Table-3 DNNs + HPCG-{S,M,L}."""
    return pack_workloads([LayerStack.from_network(n)
                           for n in NETWORKS.values()], tuple(HPCG.values()))


@lru_cache(maxsize=None)
def modern_pack(archs: Tuple[str, ...] = MODERN_COHORT,
                seq_len: int = 4096) -> WorkloadPack:
    """Modern ``configs/`` models lowered through the LayerStack adapter."""
    return pack_workloads([LayerStack.from_config(get_config(a), seq_len)
                           for a in archs])




# ---------------------------------------------------------------------------
# The batched engine
# ---------------------------------------------------------------------------


def _traffic(red, hpc_rw, hpc_mask, batches, t):
    """(W,) reductions + (NB,) batch grid -> (W, 2, NB) traffic tensors,
    float32 on the device of the inputs."""
    s_ain = t["k_im2col"] * red["a_conv"] + red["a_fc"]       # (W,)
    s_w = red["w_conv"] + t["fc_w_factor"] * red["w_fc"]
    ain, sw = s_ain[:, None], s_w[:, None]
    sin, sout = red["s_in"][:, None], red["s_out"][:, None]
    b = batches[None, :]                                       # (1, NB)
    inf_r = (b * ain + sw * (1.0 + b / t["w_tile"])) / LINE_BYTES
    inf_w = (b * sout) / LINE_BYTES
    trn_r = (2.0 * b * ain + b * sout
             + sw * (2.0 + b / t["grad_tile"])) / LINE_BYTES
    trn_w = (b * (sin + sout)
             + sw * (1.0 + b / (2.0 * t["grad_tile"]))) / LINE_BYTES
    reads = torch.stack([inf_r, trn_r], dim=1)                 # (W, 2, NB)
    writes = torch.stack([inf_w, trn_w], dim=1)
    hm = hpc_mask[:, None, None]
    reads = torch.where(hm, hpc_rw[:, 0][:, None, None], reads)
    writes = torch.where(hm, hpc_rw[:, 1][:, None, None], writes)
    frac = torch.stack([t["dram_frac_i"].expand(b.shape),
                        t["dram_frac_t"].expand(b.shape)], dim=1)
    frac = torch.where(hm, t["dram_frac_i"], frac)             # (W, 2, NB)
    dram = (reads + writes) * frac
    return reads, writes, dram


@dataclasses.dataclass(frozen=True)
class TrafficTensor:
    """One batched engine evaluation: (workload x mode x batch) arrays."""
    names: Tuple[str, ...]
    batches: Tuple[float, ...]
    reads: np.ndarray                # (W, 2, NB)
    writes: np.ndarray
    dram: np.ndarray
    hpc: Tuple[bool, ...]

    def _loc(self, name: str, mode: str, batch) -> Tuple[int, int, int]:
        if name not in self.names:
            raise ValueError(f"{name!r} not in this tensor ({self.names})")
        wi = self.names.index(name)
        if self.hpc[wi]:
            # same guard as profiles.profile(): hpc rows are mode/batch-
            # independent, so anything else asks for a mislabeled profile
            if mode != "hpc" or int(batch) != 1:
                raise ValueError(
                    f"{name} is an HPC workload: requires mode='hpc' and "
                    f"batch=1, got mode={mode!r}, batch={batch}")
            mi, bi = 0, 0
        else:
            mi = 1 if mode == "training" else 0
            if float(batch) not in self.batches:
                raise ValueError(f"batch {batch} not in this tensor "
                                 f"(has {self.batches})")
            bi = self.batches.index(float(batch))
        return wi, mi, bi

    def profile(self, name: str, mode: str, batch: int) -> MemoryProfile:
        """``MemoryProfile`` view of one (workload, mode, batch) cell."""
        wi, mi, bi = self._loc(name, mode, batch)
        return MemoryProfile(name, mode, batch,
                             float(self.reads[wi, mi, bi]),
                             float(self.writes[wi, mi, bi]),
                             float(self.dram[wi, mi, bi]))


def _t_arrays(t: Optional[Dict],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """The knobs as 0-d float32 tensors on ``device``; tensors that are
    already float32 there (e.g. leaves that require grad) pass as they
    are."""
    if t is None:
        # frozen knobs: cache the device dict, keyed on the current values
        # so in-place TRAFFIC edits are picked up
        return _frozen_t_arrays(tuple(TRAFFIC.items()), device)
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device)
            for k, v in t.items()}


@lru_cache(maxsize=8)
def _frozen_t_arrays(items, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v, dtype=torch.float32, device=device)
            for k, v in items}


@lru_cache(maxsize=32)
def _pack_device_arrays(pack: WorkloadPack, device: torch.device):
    """Per-(pack, device) engine inputs (packs hash by identity and the
    pack builders are themselves cached, so this stays warm)."""
    red = {k: torch.tensor(v, dtype=torch.float32, device=device)
           for k, v in pack.reduced.items()}
    hpc_rw = torch.tensor(np.stack([pack.hpc_reads, pack.hpc_writes], 1),
                          dtype=torch.float32, device=device)
    return red, hpc_rw, torch.tensor(pack.hpc_mask, device=device)


@lru_cache(maxsize=64)
def _batch_array(grid: Tuple[float, ...],
                 device: torch.device) -> torch.Tensor:
    return torch.tensor(grid, dtype=torch.float32, device=device)


def compute_traffic(pack: WorkloadPack, batches: Sequence[float],
                    t: Optional[Dict] = None,
                    device: DeviceLike = None) -> TrafficTensor:
    """Evaluate the full (workload x mode x batch-grid) traffic tensor in
    one batched call on ``device``.  ``t`` defaults to the frozen TRAFFIC
    knobs."""
    dev = resolve_device(device)
    grid = tuple(float(b) for b in batches)
    red, hpc_rw, hpc_mask = _pack_device_arrays(pack, dev)
    out = _traffic(red, hpc_rw, hpc_mask, _batch_array(grid, dev),
                   _t_arrays(t, dev))
    reads, writes, dram = (x.detach().cpu().numpy() for x in out)
    return TrafficTensor(pack.names, grid, reads, writes, dram,
                         tuple(bool(x) for x in pack.hpc_mask))


def modern_profiles(archs: Sequence[str] = MODERN_COHORT,
                    inference_batch: int = 4, training_batch: int = 64,
                    seq_len: int = 4096,
                    device: DeviceLike = None) -> List[MemoryProfile]:
    """Fig-3-style {I, T} profile rows for the modern-config cohort:
    one batched evaluation, same pipeline as ``paper_profiles()``."""
    pack = modern_pack(tuple(archs), seq_len)
    batches = tuple(dict.fromkeys((float(inference_batch),
                                   float(training_batch))))
    tt = compute_traffic(pack, batches, device=device)
    out: List[MemoryProfile] = []
    for name in pack.names:
        out.append(tt.profile(name, "inference", inference_batch))
        out.append(tt.profile(name, "training", training_batch))
    return out


# ---------------------------------------------------------------------------
# Differentiable §4 claim loss
# ---------------------------------------------------------------------------

# (claim key, paper target): the 13 quantitative §4 claims.
CLAIM_TARGETS = (
    ("dyn_stt", 2.2), ("dyn_sot", 1.3),
    ("leak_stt", 6.3), ("leak_sot", 10.0),
    ("tot_stt", 5.3), ("tot_sot", 8.6),
    ("edp_stt", 3.8), ("edp_sot", 4.7),
    ("ia_edp_stt", 2.0), ("ia_edp_sot", 2.3),
    ("ia_nodram_stt", 1.2),
    ("fig6_lo", 2.3), ("fig6_hi", 4.6),
)


def make_claim_loss(inference_batch: int = 4, training_batch: int = 64,
                    device: DeviceLike = None):
    """Build the differentiable claim pipeline over the traffic engine.

    Returns ``(loss_fn, claims_fn)``: ``loss_fn(t)`` takes the six knobs
    as 0-d float32 tensors on the device and returns the mean
    |log(pred/target)| over the 13 §4 claims plus 0.5x the Fig-3 R/W range
    penalty, differentiable under autograd; ``claims_fn(t)`` takes floats
    (or None for the frozen knobs) and returns ``({key: (pred, target)},
    penalty)`` for reporting.  Cache PPA configurations are technology
    constants (they do not depend on the traffic knobs), so they are baked
    in and the whole traffic -> PPA -> energy/EDP pipeline is one function
    of ``t``.
    """
    from repro_torch.core import energy as en
    from repro_torch.core.dram import dram_scale
    from repro_torch.core.sweep import iso_area_search
    from repro_torch.core.tuner import iso_capacity_configs

    dev = resolve_device(device)
    cfgs = iso_capacity_configs(3.0, dev)
    nvm = iso_area_search(("STT", "SOT"), cfgs["SRAM"].area_mm2, device=dev)
    ia_scale = {m: dram_scale(nvm[m].capacity_mb, 3.0) for m in nvm}
    ppa3 = {m: en.ppa_scalars(cfgs[m]) for m in cfgs}
    ppa_ia = {m: en.ppa_scalars(nvm[m]) for m in nvm}

    pack = paper_pack()
    red, hpc_rw, hpc_mask = _pack_device_arrays(pack, dev)
    batches = torch.tensor([float(inference_batch), float(training_batch),
                            128.0], dtype=torch.float32, device=dev)
    dl = [i for i, h in enumerate(pack.hpc_mask) if not h]
    hpc = [i for i, h in enumerate(pack.hpc_mask) if h]
    alex = pack.index("AlexNet")
    n_dl = len(dl)

    def _profiles(t):
        """(reads, writes, dram) in paper_profiles() order: per-net I then
        T, then HPCG, shapes (2*n_dl + n_hpc,)."""
        reads, writes, dram = _traffic(red, hpc_rw, hpc_mask, batches, t)
        rows = []
        for i in dl:
            rows.append((reads[i, 0, 0], writes[i, 0, 0], dram[i, 0, 0]))
            rows.append((reads[i, 1, 1], writes[i, 1, 1], dram[i, 1, 1]))
        for i in hpc:
            rows.append((reads[i, 0, 0], writes[i, 0, 0], dram[i, 0, 0]))
        r, w, d = (torch.stack(x) for x in zip(*rows))
        fig6 = (reads[alex, 1, 0], writes[alex, 1, 0], dram[alex, 1, 0],
                reads[alex, 1, 2], writes[alex, 1, 2], dram[alex, 1, 2])
        return r, w, d, fig6

    def claims(t):
        r, w, d, fig6 = _profiles(t)
        dl_sl = slice(0, 2 * n_dl)
        base = en.evaluate_arrays(r, w, d, ppa3["SRAM"])
        rel = {m: en.relative_arrays(base,
                                     en.evaluate_arrays(r, w, d, ppa3[m]))
               for m in ("STT", "SOT")}
        ia = {m: en.relative_arrays(
            base, en.evaluate_arrays(r, w, d * ia_scale[m], ppa_ia[m]))
            for m in ("STT", "SOT")}
        out = {
            "dyn_stt": torch.mean(rel["STT"]["dynamic"][dl_sl]),
            "dyn_sot": torch.mean(rel["SOT"]["dynamic"][dl_sl]),
            "leak_stt": 1.0 / torch.mean(rel["STT"]["leakage"][dl_sl]),
            "leak_sot": 1.0 / torch.mean(rel["SOT"]["leakage"][dl_sl]),
            "tot_stt": 1.0 / torch.mean(rel["STT"]["total"][dl_sl]),
            "tot_sot": 1.0 / torch.mean(rel["SOT"]["total"][dl_sl]),
            "edp_stt": 1.0 / torch.min(rel["STT"]["edp_with_dram"]),
            "edp_sot": 1.0 / torch.min(rel["SOT"]["edp_with_dram"]),
            "ia_edp_stt": 1.0 / torch.mean(ia["STT"]["edp_with_dram"]),
            "ia_edp_sot": 1.0 / torch.mean(ia["SOT"]["edp_with_dram"]),
            "ia_nodram_stt": 1.0 / torch.mean(ia["STT"]["edp"]),
        }
        for key, (ri, wi, di) in (("fig6_lo", fig6[0:3]),
                                  ("fig6_hi", fig6[3:6])):
            b6 = en.evaluate_arrays(ri, wi, di, ppa3["SRAM"])
            s6 = en.evaluate_arrays(ri, wi, di, ppa3["STT"])
            out[key] = 1.0 / en.relative_arrays(b6, s6)["edp_with_dram"]
        rw = r / torch.clamp_min(w, 1.0)
        pen = (torch.sum(torch.relu(rw / 26.0 - 1.0))
               + torch.sum(torch.relu(1.5 / torch.clamp_min(rw, 0.1)
                                      - 1.0)))
        return out, pen

    def loss_fn(t):
        preds, pen = claims(t)
        errs = torch.stack([torch.abs(torch.log(preds[k] / tgt))
                            for k, tgt in CLAIM_TARGETS])
        return torch.mean(errs) + 0.5 * pen

    def claims_fn(t):
        preds, pen = claims(_t_arrays(t, dev))
        return ({k: (float(preds[k]), tgt) for k, tgt in CLAIM_TARGETS},
                float(pen))

    return loss_fn, claims_fn
