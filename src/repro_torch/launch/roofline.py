"""Roofline terms of the port's measured traffic (torch counterpart of
``repro/launch/roofline.py``).

    compute_term    = flops_per_device / PEAK_FLOPS
    memory_term     = bytes_per_device / HBM_BW
    collective_term = link_bytes_per_device / ICI_BW

The JAX package takes flops, bytes and collectives from the compiled
program's HLO; the port counts them from its own op graph
(``launch/graph_analysis.py``: an ``OpStats`` and its ``CollectiveStats``,
the counterpart of ``parse_collectives``, by the same ring-model factors)
and ``analyze`` / ``Roofline.from_stats`` turn the count into these
terms.  One device moves no collective bytes.  ``dtype_bytes`` is also the sizing convention
of the traffic engine's ``LayerStack`` lowering (``core/traffic.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Optional, Tuple

# The modeled TPU tier's inputs (a v5e-class chip, per chip), the same as
# the JAX package's, so that the port's NVM verdicts compare with its:
# they turn counted flops and bytes into modeled times.  They are not
# measurements of any card, and no time derived from them is one.
PEAK_FLOPS = 197e12        # bf16 FLOP/s
HBM_BW = 819e9             # bytes/s
ICI_BW = 50e9              # bytes/s per link

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

# dtype-name spellings of the HLO shorthands above
_DTYPE_ALIASES = {"bfloat16": "bf16", "float16": "f16", "float32": "f32",
                  "float64": "f64", "int8": "s8", "int32": "s32",
                  "float8_e4m3fn": "f8e4m3fn", "float8_e5m2": "f8e5m2"}


def dtype_bytes(dtype: str) -> int:
    """Bytes per element of an HLO-shorthand or long dtype name."""
    key = _DTYPE_ALIASES.get(dtype, dtype)
    if key not in _DTYPE_BYTES:
        raise KeyError(f"unknown dtype {dtype!r}")
    return _DTYPE_BYTES[key]


def _ring(op: str, n: int, out_bytes: float) -> Tuple[float, float]:
    """(payload, link bytes) of one collective by the JAX package's
    ring-model factors (``repro/launch/roofline.py:112-130``)."""
    if op == "all-reduce":
        payload, factor = out_bytes, 2.0 * (n - 1) / max(n, 1)
    elif op == "all-gather":
        payload, factor = out_bytes, (n - 1) / max(n, 1)
    elif op == "reduce-scatter":
        payload, factor = out_bytes * n, (n - 1) / max(n, 1)
    elif op == "all-to-all":
        payload, factor = out_bytes, (n - 1) / max(n, 1)
    else:                                  # collective-permute
        payload, factor = out_bytes, 1.0
    return payload, payload * factor


@dataclasses.dataclass
class CollectiveStats:
    """The collectives of a counted region, by JAX op name (the fields of
    ``repro.launch.roofline.CollectiveStats``)."""
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    op_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)         # ring-model per-device link bytes
    raw_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)         # payload bytes (no ring factor)

    @property
    def total_bytes(self) -> float:
        return sum(self.op_bytes.values())

    def add(self, op: str, n: int, out_bytes: float, times: int = 1) -> None:
        payload, link = _ring(op, n, out_bytes)
        self.op_counts[op] = self.op_counts.get(op, 0) + times
        self.op_bytes[op] = self.op_bytes.get(op, 0.0) + times * link
        self.raw_bytes[op] = self.raw_bytes.get(op, 0.0) + times * payload

    def merge(self, other: "CollectiveStats", times: int = 1) -> None:
        for mine, theirs in ((self.op_counts, other.op_counts),
                             (self.op_bytes, other.op_bytes),
                             (self.raw_bytes, other.raw_bytes)):
            for name, v in theirs.items():
                mine[name] = mine.get(name, 0) + times * v


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float = 0.0
    bytes_by_op: Optional[Dict[str, float]] = None
    flops_by_op: Optional[Dict[str, float]] = None
    kernel_calls: Optional[Dict[str, int]] = None
    collectives: Optional[Dict[str, float]] = None
    collective_counts: Optional[Dict[str, int]] = None

    @classmethod
    def from_stats(cls, stats) -> "Roofline":
        """Terms of a ``graph_analysis.OpStats`` count on one device, with
        its collectives: the part ``analyze(compiled)`` plays in the JAX
        package."""
        coll = stats.collectives
        return cls(flops_per_device=stats.flops,
                   bytes_per_device=stats.bytes,
                   collective_bytes=coll.total_bytes,
                   bytes_by_op=dict(stats.bytes_by_op),
                   flops_by_op=dict(stats.flops_by_op),
                   kernel_calls=dict(stats.kernel_calls),
                   collectives=dict(coll.op_bytes),
                   collective_counts=dict(coll.op_counts))

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def terms(self, div: float = 1.0) -> Dict[str, float]:
        """The six roofline terms of a record, each divided by ``div``
        (the ticks, calls or steps the count covers)."""
        return {"flops_per_device": self.flops_per_device / div,
                "bytes_per_device": self.bytes_per_device / div,
                "collective_bytes": self.collective_bytes / div,
                "compute_s": self.compute_s / div,
                "memory_s": self.memory_s / div,
                "collective_s": self.collective_s / div}

    def model_flops_util(self, model_flops_per_device: float) -> float:
        """MODEL_FLOPS fraction of the roofline bound (MFU-like)."""
        if self.bound_s <= 0:
            return 0.0
        return model_flops_per_device / PEAK_FLOPS / self.bound_s

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes": self.collective_bytes,
            "bytes_by_op": self.bytes_by_op,
            "flops_by_op": self.flops_by_op,
            "kernel_calls": self.kernel_calls,
            "collectives": self.collectives,
            "collective_counts": self.collective_counts,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


@contextlib.contextmanager
def parse_collectives() -> Iterator[CollectiveStats]:
    """The collectives the body runs, counted as they reach the
    dispatcher (those of DTensor redistributions too): the counterpart of
    the JAX package's ``parse_collectives`` of a program's HLO.  Yields
    the ``CollectiveStats`` that fills as the body runs."""
    from repro_torch.launch.graph_analysis import OpCounter
    counter = OpCounter(per_shard=True)
    with counter:
        yield counter.stats.collectives


def analyze(stats) -> Roofline:
    """The roofline of one device's counted work, an ``OpStats`` with its
    ``CollectiveStats`` (the counterpart of ``analyze(compiled)``)."""
    return Roofline.from_stats(stats)


def model_flops(cfg, shape, chips: int) -> float:
    """Per-device MODEL_FLOPS: 6·N·D train, 2·N·tokens serve (N = active)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        total = 6.0 * n_active * shape.seq_len * shape.global_batch
    elif shape.kind == "prefill":
        total = 2.0 * n_active * shape.seq_len * shape.global_batch
    else:  # decode: one token per sequence
        total = 2.0 * n_active * shape.global_batch
    return total / chips
