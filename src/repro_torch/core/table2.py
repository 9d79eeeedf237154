"""Paper Table 2: EDAP-tuned cache PPA anchors.

The single source for the 30 anchor numbers {SRAM 3MB, STT 3/7MB,
SOT 3/10MB} x {read/write latency, read/write energy, leakage, area} —
the calibration targets of ``tools/calibrate_cache.py`` and the regression
contract checked by the tests and ``benchmarks/table2_cache.py``.
"""
from __future__ import annotations

from typing import Dict, Tuple

TABLE2_ANCHORS: Dict[Tuple[str, int], Dict[str, float]] = {
    ("SRAM", 3): dict(read_latency_ns=2.91, write_latency_ns=1.53,
                      read_energy_nj=0.35, write_energy_nj=0.32,
                      leakage_mw=6442, area_mm2=5.53),
    ("STT", 3): dict(read_latency_ns=2.98, write_latency_ns=9.31,
                     read_energy_nj=0.81, write_energy_nj=0.31,
                     leakage_mw=748, area_mm2=2.34),
    ("STT", 7): dict(read_latency_ns=4.58, write_latency_ns=10.06,
                     read_energy_nj=0.93, write_energy_nj=0.43,
                     leakage_mw=1706, area_mm2=5.12),
    ("SOT", 3): dict(read_latency_ns=3.71, write_latency_ns=1.38,
                     read_energy_nj=0.49, write_energy_nj=0.22,
                     leakage_mw=527, area_mm2=1.95),
    ("SOT", 10): dict(read_latency_ns=6.69, write_latency_ns=2.47,
                      read_energy_nj=0.51, write_energy_nj=0.40,
                      leakage_mw=1434, area_mm2=5.64),
}
