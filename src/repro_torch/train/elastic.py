"""Elastic scaling and straggler mitigation (torch counterpart of
``repro/train/elastic.py``).

Elastic scaling: when the healthy-device count changes (node failure,
capacity add), pick the best mesh from a preference ladder
(``choose_mesh``), rebuild shardings from the SAME logical-axis rules
(``sharding/rules.py``) and restore the latest checkpoint onto the new
mesh.  Nothing about the model or step function changes: that is the
point of rule-based sharding.  ``remesh`` builds the chosen mesh on the
current default process group (``launch/mesh.py``), so the group's world
size must be the device count.

Straggler mitigation: an EMA step-time monitor per host; a host whose step
time exceeds ``threshold`` x the fleet median for ``patience`` consecutive
steps is reported for eviction, which triggers the elastic path above.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Sequence, Tuple

from repro_torch.launch.mesh import make_mesh_for


@dataclasses.dataclass(frozen=True)
class MeshChoice:
    devices: int
    model_parallelism: int
    pods: int


def choose_mesh(num_devices: int,
                preferences: Sequence[Tuple[int, int]] = ((16, 2), (16, 1),
                                                          (8, 1), (4, 1),
                                                          (2, 1), (1, 1))
                ) -> MeshChoice:
    """Largest viable (model_parallelism, pods) config for device count."""
    for model, pods in preferences:
        if num_devices % (model * pods) == 0 and num_devices >= model * pods:
            return MeshChoice(num_devices, model, pods)
    return MeshChoice(num_devices, 1, 1)


def remesh(num_devices: int):
    c = choose_mesh(num_devices)
    return make_mesh_for(c.devices, model_parallelism=c.model_parallelism,
                         pods=c.pods)


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


@dataclasses.dataclass
class ElasticEvent:
    kind: str            # "failure" | "straggler" | "scale_up"
    hosts: List[int]
    new_device_count: int


def plan_recovery(event: ElasticEvent):
    """Return (mesh_choice, action) for an elastic event.  The runner then:
    1) quiesces, 2) builds the new mesh, 3) restores the latest checkpoint
    with shardings derived from the same rules on the new mesh, 4) resumes
    the data pipeline at the checkpointed step."""
    choice = choose_mesh(event.new_device_count)
    return choice, ("evict+remesh" if event.kind != "scale_up"
                    else "quiesce+remesh")
