"""Transaction-level energy / delay / EDP model (paper §4 calculations).

Per the paper: "we multiply the number of read and write transactions by
the corresponding latency and energy values for those operations"; leakage
energy integrates leakage power over the execution window; DRAM energy and
latency are added where stated (Figs 5, 6, 9).

Two views of the same math: the scalar ``evaluate``/``relative`` pair
(one ``MemoryProfile`` against one ``CachePPA``), and the array-native
``evaluate_arrays``/``relative_arrays`` pair that ``iso``/``scaling`` and
the traffic-engine claim loss (``core.traffic``) run over whole traffic
tensors: plain broadcasting on whatever device the tensors live on,
differentiable end to end under autograd.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Dict, Optional

from repro_torch.core.cache_model import CachePPA
from repro_torch.core.constants import DRAM_ENERGY_NJ, DRAM_LATENCY_NS

if TYPE_CHECKING:  # runtime import would cycle through core.traffic
    from repro_torch.core.profiles import MemoryProfile


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """All paper §4 quantities for one (workload, cache) pair. Units:
    energy nJ, delay ns."""
    workload: str
    mem: str
    dynamic_nj: float
    leakage_nj: float
    dram_nj: float
    delay_ns: float           # L2-only execution window
    delay_dram_ns: float      # incl. DRAM transactions

    @property
    def total_nj(self) -> float:
        return self.dynamic_nj + self.leakage_nj

    @property
    def total_with_dram_nj(self) -> float:
        return self.dynamic_nj + self.leakage_nj + self.dram_nj

    @property
    def edp(self) -> float:   # no DRAM (Fig 9 top)
        return self.total_nj * self.delay_ns

    @property
    def edp_with_dram(self) -> float:  # Figs 5/6/9 bottom
        return self.total_with_dram_nj * self.delay_dram_ns


def evaluate(p: MemoryProfile, ppa: CachePPA,
             dram_transactions: Optional[float] = None) -> EnergyReport:
    """Energy/delay of running profile ``p`` against cache ``ppa``."""
    n_dram = p.dram if dram_transactions is None else dram_transactions
    dyn = p.l2_reads * ppa.read_energy_nj + p.l2_writes * ppa.write_energy_nj
    delay = (p.l2_reads * ppa.read_latency_ns
             + p.l2_writes * ppa.write_latency_ns)
    delay_dram = delay + n_dram * DRAM_LATENCY_NS
    # mW * ns = pJ -> /1000 nJ; leakage integrates over the DRAM-inclusive
    # execution window (the cache leaks while DRAM is serving misses too)
    leak = ppa.leakage_mw * delay_dram * 1e-3
    dram_e = n_dram * DRAM_ENERGY_NJ
    return EnergyReport(
        workload=p.label, mem=ppa.mem,
        dynamic_nj=dyn, leakage_nj=leak, dram_nj=dram_e,
        delay_ns=delay, delay_dram_ns=delay_dram,
    )


def relative(base: EnergyReport, other: EnergyReport) -> Dict[str, float]:
    """Normalized-to-base metrics (paper plots are normalized to SRAM)."""
    return {
        "dynamic": other.dynamic_nj / base.dynamic_nj,
        "leakage": other.leakage_nj / base.leakage_nj,
        "total": other.total_nj / base.total_nj,
        "delay": other.delay_ns / base.delay_ns,
        "edp": other.edp / base.edp,
        "edp_with_dram": other.edp_with_dram / base.edp_with_dram,
    }


# --- array-native view (whole traffic tensors) ------------------------------

# PPA fields consumed by the energy math, in the order ``ppa_scalars`` emits
PPA_ENERGY_FIELDS = ("read_energy_nj", "write_energy_nj", "read_latency_ns",
                     "write_latency_ns", "leakage_mw")

# metric keys shared by ``relative`` and ``relative_arrays``
RELATIVE_METRICS = ("dynamic", "leakage", "total", "delay", "edp",
                    "edp_with_dram")


def ppa_scalars(ppa: CachePPA) -> Dict[str, float]:
    """The energy-relevant fields of one tuned config, as plain floats
    (broadcast against traffic arrays of any shape)."""
    return {f: float(getattr(ppa, f)) for f in PPA_ENERGY_FIELDS}


def evaluate_arrays(reads, writes, dram, ppa: Dict,
                    leak_scale: float = 1.0) -> Dict:
    """Array version of ``evaluate``: all §4 quantities for traffic arrays
    of any (broadcastable) shape against one PPA field dict — the same
    formulas, element-wise.  ``ppa`` values may themselves be arrays
    (e.g. a capacity axis) as long as they broadcast against the traffic.
    ``leak_scale`` derates leakage."""
    dyn = reads * ppa["read_energy_nj"] + writes * ppa["write_energy_nj"]
    delay = (reads * ppa["read_latency_ns"]
             + writes * ppa["write_latency_ns"])
    delay_dram = delay + dram * DRAM_LATENCY_NS
    leak = leak_scale * ppa["leakage_mw"] * delay_dram * 1e-3
    dram_e = dram * DRAM_ENERGY_NJ
    total = dyn + leak
    return {
        "dynamic": dyn, "leakage": leak, "total": total,
        "dram": dram_e, "delay": delay, "delay_dram": delay_dram,
        "edp": total * delay,
        "edp_with_dram": (total + dram_e) * delay_dram,
    }


def relative_arrays(base: Dict, other: Dict) -> Dict:
    """Array version of ``relative`` — element-wise normalized metrics."""
    return {k: other[k] / base[k] for k in RELATIVE_METRICS}
