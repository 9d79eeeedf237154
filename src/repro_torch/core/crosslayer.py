"""Cross-layer TPU-mode analysis: the paper's pipeline pointed at the
port's own workloads (torch counterpart of ``repro/core/crosslayer.py``).

DeepNVM++'s cross-layer link is: measured workload memory behavior ->
technology-dependent cache PPA -> energy/EDP verdict.  Here the "measured
memory behavior" is the per-device traffic of a serve phase or train
window (the records of ``serve.engine.Engine.serve_records`` and
``train.trainer.TrainWindow.train_records``, counted from the port's own
op graph by ``launch/graph_analysis.py``), or of a dry-run record, and
the modeled cache is an NVM-vs-SRAM *on-chip SRAM tier* of a TPU-class
accelerator (v5e-like, ``core/constants.py``).  Reads vs writes are split
with the roofline convention (every modeled surface byte is one write +
one read -> read fraction ~ operand share).

Outputs, per record: SRAM/STT/SOT tier energy per step, leakage over the
step's roofline-bound time, EDP ratios -- "would an MRAM last-level tier
help THIS workload", the question the paper asks of 2016-era GPUs.  The
times in a record are modeled at the TPU tier's constants
(``launch/roofline.py``), not measured on any card.

The arithmetic runs in float32 tensors on CUDA unless ``device="cpu"``
is given, as every core function (the engines pass their own device).
"""
from __future__ import annotations

import dataclasses
import json
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Sequence, Union

import torch

from repro_torch.core.cache_model import CachePPA
from repro_torch.core.constants import LINE_BYTES, TPU_SRAM_TIER_MB
from repro_torch.core.tuner import iso_capacity_configs
from repro_torch.device import DeviceLike, resolve_device

# traffic split: fraction of modeled surface bytes that are reads.
# Inference/dry-run convention (operand-reuse dominated): 0.60.  Training
# adds whole write streams the inference mix lacks (gradients, Adam
# moments, activation spills for backward), so its split sits at the
# one-write-one-read-per-surface-byte point (paper Fig. 3: training R/W
# ratios cluster near 1, vs >2 for inference); the STT/SOT verdicts hinge
# on this because MRAM write energy is the dominant penalty term.
READ_FRACTION = 0.60
TRAIN_READ_FRACTION = 0.50
# recurrent-bank serving (ssm/hybrid slot-state banks) rewrites the whole
# conv/SSD/RG-LRU state every tick where KV decode appends one row and
# reads the rest: the write-heaviest serve regime modeled, below even the
# training split (cf. arXiv 2308.02024 on STT-MRAM write asymmetry
# dominating exactly this small-hot-state pattern).
RECURRENT_READ_FRACTION = 0.45
# a 100+MB accelerator SRAM tier uses high-density low-leak cells, not the
# HP cells the GPU-L2 calibration fit; derate SRAM leakage accordingly so
# the TPU-mode verdict is not an HP-leakage artifact.
SRAM_LEAK_DERATE = 0.12


@dataclasses.dataclass(frozen=True)
class CellVerdict:
    arch: str
    shape: str
    mesh: str
    reads: float                  # tier transactions per step per device
    writes: float
    step_s: float                 # roofline-bound step time (modeled)
    energy_ratio: Dict[str, float]    # mem -> vs SRAM
    edp_ratio: Dict[str, float]

    def to_dict(self):
        return dataclasses.asdict(self)


@lru_cache(maxsize=None)
def _tier_configs(tier_mb: float, device: torch.device
                  ) -> Dict[str, CachePPA]:
    return iso_capacity_configs(tier_mb, device=device)


def analyze_records(recs: List[Dict], tier_mb: float = TPU_SRAM_TIER_MB,
                    read_fraction: Union[float, Sequence[float],
                                         torch.Tensor] = READ_FRACTION,
                    device: DeviceLike = None) -> List[CellVerdict]:
    """Batched verdicts: every record's (reads, writes, step time) is
    stacked into (N,) float32 tensors and evaluated against all three tier
    memories in one pass.  ``read_fraction`` is the mode-dependent read
    share of the modeled surface bytes (train mode passes the write-heavier
    ``TRAIN_READ_FRACTION``); a scalar applies to every record, an (N,)
    sequence gives each record its own split (serve mode mixes families
    with different splits)."""
    if not recs:
        return []
    dev = resolve_device(device)
    cfgs = _tier_configs(float(tier_mb), dev)
    roofs = [r["roofline"] for r in recs]

    def col(key):
        return torch.tensor([float(r[key]) for r in roofs],
                            dtype=torch.float32, device=dev)

    if not isinstance(read_fraction, (int, float)):
        read_fraction = torch.as_tensor(read_fraction, dtype=torch.float32,
                                        device=dev)
    byts = col("bytes_per_device")
    reads = byts * read_fraction / LINE_BYTES
    writes = byts * (1 - read_fraction) / LINE_BYTES
    comp, mem, coll = col("compute_s"), col("memory_s"), col("collective_s")
    step = torch.maximum(torch.maximum(comp, mem), coll)
    e, d = {}, {}
    for m, ppa in cfgs.items():
        derate = SRAM_LEAK_DERATE if m == "SRAM" else 1.0
        dyn = (reads * ppa.read_energy_nj + writes * ppa.write_energy_nj)
        leak = derate * ppa.leakage_mw * 1e-3 * step * 1e9          # nJ
        e[m] = dyn + leak
        # NVM extra access latency only matters on the memory-bound
        # fraction; step time is roofline-bound, so delay scales with the
        # tier's read latency when memory dominates, else stays put.
        mem_scale = ppa.read_latency_ns / cfgs["SRAM"].read_latency_ns
        d[m] = torch.maximum(torch.maximum(comp, mem * mem_scale), coll)
    e = {m: v.cpu().numpy() for m, v in e.items()}
    d = {m: v.cpu().numpy() for m, v in d.items()}
    reads, writes, step = (x.cpu().numpy() for x in (reads, writes, step))
    return [CellVerdict(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        reads=float(reads[i]), writes=float(writes[i]),
        step_s=float(step[i]),
        energy_ratio={m: float(e[m][i] / e["SRAM"][i])
                      for m in ("STT", "SOT")},
        edp_ratio={m: float((e[m][i] * d[m][i])
                            / (e["SRAM"][i] * d["SRAM"][i]))
                   for m in ("STT", "SOT")},
    ) for i, rec in enumerate(recs)]


def analyze_record(rec: Dict, tier_mb: float = TPU_SRAM_TIER_MB,
                   device: DeviceLike = None) -> CellVerdict:
    """Single-record view over the batched ``analyze_records``."""
    return analyze_records([rec], tier_mb, device=device)[0]


_SERVE_ROOF_KEYS = ("bytes_per_device", "compute_s", "memory_s",
                    "collective_s")


def _require_roofline(records: List[Dict], hint: str) -> None:
    """Validate that engine-measured records carry the roofline terms the
    batched verdict pass needs, naming the offending record."""
    for rec in records:
        roof = rec.get("roofline") or {}
        missing = [k for k in _SERVE_ROOF_KEYS if k not in roof]
        if missing:
            raise ValueError(
                f"record {rec.get('shape', '?')!r} is missing roofline "
                f"terms {missing}; {hint}")


def analyze_serve(records: List[Dict], tier_mb: float = TPU_SRAM_TIER_MB,
                  device: DeviceLike = None) -> List[CellVerdict]:
    """Serve-mode NVM verdicts from engine-measured traffic records.

    ``records`` come from ``serve.engine.Engine.serve_records()``: one
    record per serve phase whose roofline terms are the counted decode
    tick's or prefill call's per-device traffic.  Decode ticks are the
    memory-bound regime where DeepNVM++ (arXiv 2012.04559) predicts MRAM
    last-level tiers pay off most.

    A record's ``read_fraction`` (the serve engines tag ssm/hybrid traffic
    with ``RECURRENT_READ_FRACTION``: recurrent banks are rewritten in full
    every tick) overrides ``READ_FRACTION`` for that record only.

    A record's ``unique_page_fraction`` (the paged engine's measured share
    of physically-unique KV page reads per decode window,
    ``PagedEngine.serve_records``) scales its ``bytes_per_device`` and
    ``memory_s`` before scoring: prefix sharing maps many slots onto the
    same physical pages, so the tier's traffic shrinks with sharing.
    Compute and collective terms are left alone.

    Raises ``ValueError`` naming the offending record when roofline terms
    are missing (e.g. the engine ran with ``record_traffic=False`` and a
    record was assembled by hand), or when a fraction is out of range.
    """
    _require_roofline(records, "run the engine with record_traffic=True")
    scaled = []
    for rec in records:
        upf = rec.get("unique_page_fraction")
        if upf is None:
            scaled.append(rec)
            continue
        if not 0.0 < upf <= 1.0:
            raise ValueError(
                f"record {rec.get('shape', '?')!r}: unique_page_fraction "
                f"{upf} outside (0, 1]")
        roof = dict(rec["roofline"])
        roof["bytes_per_device"] *= upf
        roof["memory_s"] *= upf
        scaled.append({**rec, "roofline": roof})
    for rec in scaled:
        rf = rec.get("read_fraction")
        if rf is not None and not 0.0 < rf < 1.0:
            raise ValueError(
                f"record {rec.get('shape', '?')!r}: read_fraction {rf} "
                f"outside (0, 1)")
    rfs = [float(r.get("read_fraction", READ_FRACTION)) for r in scaled]
    return analyze_records(scaled, tier_mb, read_fraction=rfs,
                           device=device)


def analyze_train(records: List[Dict], tier_mb: float = TPU_SRAM_TIER_MB,
                  device: DeviceLike = None) -> List[CellVerdict]:
    """Train-mode NVM verdicts from fused-window traffic records.

    ``records`` come from ``train.trainer.TrainWindow.train_records()``:
    per-STEP roofline terms of the counted K-step window (forward +
    backward + optimizer + on-device batch hashing).  Training is the
    write-heavy regime of the paper's Fig. 3 R/W ratios, so the split is
    ``TRAIN_READ_FRACTION``, not the inference convention: identical
    roofline terms score differently here than under ``analyze_serve``.

    Raises ``ValueError`` naming the offending record when roofline terms
    are missing (e.g. the window ran with ``record_traffic=False`` and a
    record was assembled by hand).
    """
    _require_roofline(records,
                      "run the train window with record_traffic=True")
    return analyze_records(records, tier_mb,
                           read_fraction=TRAIN_READ_FRACTION, device=device)


def analyze_dryrun_dir(results_dir: str, tag: str = "baseline",
                       tier_mb: float = TPU_SRAM_TIER_MB,
                       device: DeviceLike = None) -> List[CellVerdict]:
    """Batched verdicts for every ``*__{tag}.json`` record in a dry-run
    results dir.  Raises ``FileNotFoundError`` naming the dir and tag when
    the dir is missing or holds no matching records."""
    d = Path(results_dir)
    if not d.is_dir():
        raise FileNotFoundError(
            f"dry-run results dir {str(d)!r} does not exist "
            f"(tag {tag!r}); run launch/dryrun.py first")
    paths = sorted(d.glob(f"*__{tag}.json"))
    if not paths:
        raise FileNotFoundError(
            f"no '*__{tag}.json' records in {str(d)!r}; "
            f"run launch/dryrun.py with --tag {tag}")
    return analyze_records([json.loads(p.read_text()) for p in paths],
                           tier_mb, device=device)
