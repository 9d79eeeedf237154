"""Deterministic fault injection for the serve engines (torch counterpart of
``repro/serve/chaos.py``).

A ``FaultPlan`` is a seeded list of ``Fault``s bound to an engine via
``Engine(fault_plan=...)``.  The engine calls ``plan.on_site(site, eng)``
at three named sites every ``step()``; the plan counts visits per site
and fires each fault inside its ``[at, at + count)`` visit window.

    site "pre_admit"     — before admission plans page reservations
        pool_exhaust : steal up to ``pages`` free pages for ``hold``
                       admission rounds (``held_refs()`` reports them, so
                       that conservation checks stay exact)
        cow_storm    : copy ``pages`` random live pages into scratch pages
                       on the device, then free the scratch pages
    site "pre_window"    — after the page-table upload, before the window
        nan_logits   : set the engine's one-shot poison operand for one
                       slot: that row's logits are NaN for one window
        kv_corrupt   : write NaN into one slot's state in the device cache
                       (positioned banks: position 0 of the slot row;
                       positionless recurrent banks: the whole row; paged
                       caches: position 0 of the slot's first page, which
                       may be shared through the radix tree)
    site "window_launch" — inside the watchdog's attempt, before the window
        window_stall : raise ``InjectedFault`` before the window touches
                       the device, so that the watchdog retries, and
                       degrades once every attempt failed

Only position 0 of a positioned bank is corrupted (it is always written
and attended), so a fault surfaces as non-finite logits in the window
health check, whatever a kernel does with lanes it never reads.  Victims
and copy sources come from the plan's own ``np.random.default_rng(seed)``
in the JAX package's call order, so one plan picks the same slots and
pages in both packages.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Optional

import numpy as np

SITES = ("pre_admit", "pre_window", "window_launch")

KIND_SITE = {
    "pool_exhaust": "pre_admit",
    "cow_storm": "pre_admit",
    "nan_logits": "pre_window",
    "kv_corrupt": "pre_window",
    "window_stall": "window_launch",
}


class InjectedFault(RuntimeError):
    """Raised by ``window_stall`` faults; the watchdog absorbs it."""


@dataclasses.dataclass
class Fault:
    """One fault: ``kind`` fires on site visits ``[at, at + count)``.

    ``slot`` pins nan_logits/kv_corrupt to a slot (None: a random live
    slot); ``pages`` sizes pool_exhaust steals and cow_storm copies (0:
    everything free / a burst of 2); ``hold`` is how many pre_admit rounds
    a pool_exhaust steal is held before its pages return.
    """
    kind: str
    at: int = 0
    count: int = 1
    slot: Optional[int] = None
    pages: int = 0
    hold: int = 2

    def __post_init__(self):
        if self.kind not in KIND_SITE:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; known: "
                f"{sorted(KIND_SITE)}")
        if self.at < 0 or self.count < 1 or self.hold < 0:
            raise ValueError(
                f"fault {self.kind}: need at >= 0, count >= 1, hold >= 0")


class FaultPlan:
    """Seeded, visit-counted fault schedule attached to one engine run.

    Site visit counters, not wall time, decide when faults fire, and the
    only randomness (a victim slot, copy sources) comes from the plan's
    own generator.  ``injected`` counts fires per kind; ``log`` records
    (kind, site, visit); ``held_refs()`` gives the pages a pool_exhaust
    steal holds now, and ``release_held()`` returns them.
    """

    def __init__(self, faults, seed: int = 0):
        self.faults: List[Fault] = list(faults)
        self.rng = np.random.default_rng(seed)
        self.visits: Counter = Counter()
        self.injected: Counter = Counter()
        self.log: List[tuple] = []
        self._holds: List[dict] = []   # {"pages", "pool", "release_at"}

    # ---- accounting -----------------------------------------------------
    def held_refs(self) -> Counter:
        """page -> refs currently held by pool_exhaust steals."""
        c: Counter = Counter()
        for h in self._holds:
            c.update(h["pages"])
        return c

    def release_held(self) -> int:
        """Return every stolen page to its pool; returns pages freed."""
        n = 0
        for h in self._holds:
            for p in h["pages"]:
                h["pool"].release(p)
                n += 1
        self._holds.clear()
        return n

    # ---- engine hook ----------------------------------------------------
    def on_site(self, site: str, engine) -> None:
        v = self.visits[site]
        self.visits[site] += 1
        if site == "pre_admit":
            self._release_due(v)
        for f in self.faults:
            if KIND_SITE[f.kind] != site:
                continue
            if not (f.at <= v < f.at + f.count):
                continue
            self.injected[f.kind] += 1
            self.log.append((f.kind, site, v))
            getattr(self, f"_do_{f.kind}")(f, engine)

    def _release_due(self, visit: int) -> None:
        due = [h for h in self._holds if h["release_at"] <= visit]
        for h in due:
            for p in h["pages"]:
                h["pool"].release(p)
            self._holds.remove(h)

    # ---- injectors ------------------------------------------------------
    def _pick_slot(self, f: Fault, engine) -> Optional[int]:
        live = [s for s, r in enumerate(engine.slot_req) if r is not None]
        if not live:
            return None
        if f.slot is not None:
            return f.slot if engine.slot_req[f.slot] is not None else live[0]
        return live[int(self.rng.integers(len(live)))]

    def _do_nan_logits(self, f: Fault, engine) -> None:
        s = self._pick_slot(f, engine)
        if s is not None:
            engine._poison_host[s] = True

    def _do_kv_corrupt(self, f: Fault, engine) -> None:
        s = self._pick_slot(f, engine)
        if s is None:
            return
        if hasattr(engine, "_slot_pages"):            # paged cache
            pages = engine._slot_pages[s]
            if not pages:
                return
            page = int(pages[0])
            for v in engine.cache.values():
                v[:, page, :1] = float("nan")
            return
        banks = getattr(engine, "_banks", {})           # dense slot banks
        for k, v in engine.cache.items():
            if not v.is_floating_point():
                continue            # e.g. the ring position rows (int32)
            b = banks.get(k)
            idx = [slice(None)] * v.ndim
            idx[b.batch_axis if b is not None else 1] = s
            if b is not None and b.seq_axis is not None:
                # positioned bank: position 0 only (always written and
                # attended), so that the fault surfaces deterministically
                idx[b.seq_axis] = slice(0, 1)
            # positionless recurrent banks: the whole row is read every
            # tick, so poison it all
            v[tuple(idx)] = float("nan")

    def _do_pool_exhaust(self, f: Fault, engine) -> None:
        pool = getattr(engine, "pool", None)
        if pool is None:                              # dense engine: no-op
            return
        n = pool.free_pages if f.pages <= 0 else min(f.pages,
                                                     pool.free_pages)
        if n == 0:
            return
        pages = pool.alloc(n)
        self._holds.append({
            "pages": pages, "pool": pool,
            "release_at": self.visits["pre_admit"] + f.hold})

    def _do_cow_storm(self, f: Fault, engine) -> None:
        pool = getattr(engine, "pool", None)
        if pool is None:
            return
        live = [p for sp in engine._slot_pages for p in sp]
        n = min(f.pages if f.pages > 0 else 2, pool.free_pages)
        if n == 0 or not live:
            return
        # copy live pages into scratch pages, then free them: device copy
        # traffic through the admission's copy path, no net allocation
        scratch = pool.alloc(n)
        srcs = [live[int(self.rng.integers(len(live)))] for _ in range(n)]
        engine._copy_pages(srcs, scratch)
        for p in scratch:
            pool.release(p)

    def _do_window_stall(self, f: Fault, engine) -> None:
        raise InjectedFault(
            f"injected window stall "
            f"(launch visit {self.visits['window_launch'] - 1})")
