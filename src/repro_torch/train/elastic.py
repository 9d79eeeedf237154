"""Straggler mitigation (the framework-free ``StragglerMonitor`` of
``repro/train/elastic.py``, copied).  The elastic mesh half of that module
(``choose_mesh``, ``remesh``, ``plan_recovery``) comes with the sharding
slice of the port.

An EMA step-time monitor per host: a host whose step time exceeds
``threshold`` x the fleet median for ``patience`` consecutive steps is
reported for eviction.
"""
from __future__ import annotations

import statistics
from typing import Dict, List


class StragglerMonitor:
    """Flags hosts whose EMA step time exceeds threshold x fleet median."""

    def __init__(self, num_hosts: int, threshold: float = 1.5,
                 patience: int = 5, ema: float = 0.3):
        self.num_hosts = num_hosts
        self.threshold = threshold
        self.patience = patience
        self.ema_coef = ema
        self._ema: Dict[int, float] = {}
        self._strikes: Dict[int, int] = {h: 0 for h in range(num_hosts)}

    def record(self, host: int, step_time_s: float) -> None:
        prev = self._ema.get(host)
        self._ema[host] = (step_time_s if prev is None else
                           self.ema_coef * step_time_s
                           + (1 - self.ema_coef) * prev)

    def stragglers(self) -> List[int]:
        """Advance strike counters one step and report hosts that crossed
        ``patience``.  This MUTATES state — call it exactly once per
        recorded step.  A reported host's strikes reset, so it is reported
        once per sustained episode."""
        if len(self._ema) < max(2, self.num_hosts // 2):
            return []
        med = statistics.median(self._ema.values())
        out = []
        for h, t in self._ema.items():
            if t > self.threshold * med:
                self._strikes[h] += 1
            else:
                self._strikes[h] = 0
            if self._strikes[h] >= self.patience:
                out.append(h)
                self._strikes[h] = 0
        return out
