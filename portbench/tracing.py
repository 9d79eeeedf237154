"""The reduction from a ``torch.profiler`` trace to what the per-layer
readers take: device operations (kernels, copies, sets) with their times,
host ranges and the runtime calls that launched each operation, all on the
profiler's clock (nanoseconds), and the offset from ``time.perf_counter``
to it, fixed from the benchmark's own ``bench.*`` ranges.

The busy share is the union of device-operation intervals over the traced
window; each idle gap is named by the innermost host event that covers
its middle, inside the innermost ``bench.*`` range there, and the gaps of
one name are summed."""
from __future__ import annotations

import bisect
import heapq
import statistics
from typing import Dict, List, Tuple

TOP = 10
NAME_CHARS = 96


def _attr(e, name, default=None):
    f = getattr(e, name, None)
    if f is None:
        return default
    try:
        return f()
    except Exception:           # an accessor this torch does not fill
        return default


class Trace:
    """One profiled stretch of a run, reduced."""

    def __init__(self, events, marks: List[Tuple[str, float]]):
        from torch.autograd import DeviceType
        self.device: List[Tuple[str, int, int, int]] = []   # name, s, e, corr
        self.host: List[Tuple[str, int, int, int]] = []     # name, s, e, tid
        self.launch: Dict[int, Tuple[int, int]] = {}        # corr -> (t, tid)
        for e in events:
            name = _attr(e, "name", "")
            s = _attr(e, "start_ns")
            if s is None:
                s = int(_attr(e, "start_us", 0) * 1000)
            d = _attr(e, "duration_ns")
            if d is None:
                d = int(_attr(e, "duration_us", 0) * 1000)
            if _attr(e, "device_type") == DeviceType.CUDA:
                if _attr(e, "is_user_annotation", False):
                    continue
                self.device.append((name, s, s + d, _attr(e, "correlation_id",
                                                          -1)))
            else:
                tid = _attr(e, "start_thread_id", 0)
                self.host.append((name, s, s + d, tid))
                if name.startswith("cuda") or name.startswith("cuLaunch"):
                    self.launch[_attr(e, "correlation_id", -1)] = (s, tid)
        names = {h[0] for h in self.host}
        # a host range may also show on the device timeline: not an op
        self.device = [d for d in self.device if d[0] not in names]
        self.device.sort(key=lambda d: d[1])
        # perf_counter -> profiler clock, from the bench.* ranges' starts
        starts = {}
        for name, s, _, _ in self.host:
            if name.startswith("bench."):
                starts.setdefault(name, []).append(s)
        offs = []
        seen: Dict[str, int] = {}
        for name, t in marks:
            i = seen.get(name, 0)
            seen[name] = i + 1
            if i < len(starts.get(name, [])):
                offs.append(starts[name][i] - t * 1e9)
        self.offset_ns = statistics.median(offs) if offs else None
        bench = [h for h in self.host if h[0].startswith("bench.")]
        self.t0 = min(h[1] for h in bench) if bench else (
            self.device[0][1] if self.device else 0)
        self.t1 = max(h[2] for h in bench) if bench else (
            self.device[-1][2] if self.device else 0)

    # ---- clock ---------------------------------------------------------
    def ns(self, perf_s: float) -> float:
        """A ``time.perf_counter`` reading on the profiler's clock."""
        return perf_s * 1e9 + self.offset_ns

    # ---- device --------------------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def merged(self) -> List[Tuple[int, int]]:
        """Device-busy intervals inside the window, merged."""
        out: List[List[int]] = []
        for _, s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e9

    def ops(self, contains: str = "", t0=None, t1=None):
        """Device operations whose name contains ``contains`` and whose
        start lies in [t0, t1] (profiler ns; default the window)."""
        t0 = self.t0 if t0 is None else t0
        t1 = self.t1 if t1 is None else t1
        return [d for d in self.device
                if t0 <= d[1] <= t1 and contains in d[0]]

    def op_seconds(self, contains: str = "", t0=None, t1=None) -> float:
        return sum(e - s for _, s, e, _ in self.ops(contains, t0, t1)) / 1e9

    def launched_inside(self, range_name: str) -> float:
        """Device seconds of the operations launched (by the runtime call
        that carries their correlation id) inside a host range
        ``range_name`` on the same thread."""
        spans: Dict[int, List[Tuple[int, int]]] = {}
        for name, s, e, tid in self.host:
            if name == range_name:
                spans.setdefault(tid, []).append((s, e))
        for v in spans.values():
            v.sort()
        total = 0
        for _, s, e, corr in self.ops():
            hit = self.launch.get(corr)
            if hit is None or hit[1] not in spans:
                continue
            rs = spans[hit[1]]
            i = bisect.bisect_right(rs, (hit[0], float("inf"))) - 1
            if i >= 0 and rs[i][0] <= hit[0] <= rs[i][1]:
                total += e - s
        return total / 1e9

    # ---- breakdown -----------------------------------------------------
    def top_ops(self) -> List[list]:
        by: Dict[str, int] = {}
        for name, s, e, _ in self.ops():
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n[:NAME_CHARS], d / 1e9] for n, d in top]

    def _names_at(self, times: List[float]) -> List[str]:
        """For each time (ascending), what the host was doing: the
        innermost (shortest) host event covering it, inside the innermost
        ``bench.*`` range covering it; one sweep over the events."""
        events = sorted(self.host, key=lambda h: h[1])
        heaps: Dict[bool, list] = {True: [], False: []}
        out, i = [], 0
        for t in times:
            while i < len(events) and events[i][1] <= t:
                name, s, e, _ = events[i]
                heapq.heappush(heaps[name.startswith("bench.")],
                               (e - s, e, name))
                i += 1
            found = {}
            for bench, h in heaps.items():
                while h and h[0][1] < t:
                    heapq.heappop(h)
                found[bench] = h[0][2] if h else None
            what = (found[False] or "python (no op)")[:NAME_CHARS]
            where = found[True] or "outside the benchmark's ranges"
            out.append(f"{what} in {where}")
        return out

    def idle_gaps(self) -> List[list]:
        """The idle time of the traced window by what the host was doing:
        each stretch with no device operation is named by the host's
        innermost event at its middle, and the stretches of one name are
        summed; the names with the most idle seconds."""
        gaps = []
        prev = self.t0
        for s, e in self.merged() + [(self.t1, self.t1)]:
            if s > prev:
                gaps.append(((prev + s) / 2, s - prev))
            prev = max(prev, e)
        gaps.sort()
        by: Dict[str, int] = {}
        for name, (_, d) in zip(self._names_at([m for m, _ in gaps]), gaps):
            by[name] = by.get(name, 0) + d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[n, d / 1e9] for n, d in top]


def _activities():
    import torch
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


class Profiler:
    """A ``torch.profiler`` session over CPU and CUDA that the drivers start
    and stop around the stretch they trace, and the ``bench.*`` marks
    (``time.perf_counter`` at each range's entry) that fix the clock."""

    def __init__(self):
        from torch.profiler import profile
        self.prof = profile(activities=_activities())
        self.marks: List[Tuple[str, float]] = []
        self.on = False

    def warm(self) -> None:
        """Start and stop once, so that the tracer's own set-up falls in
        the benchmark's set-up."""
        import torch
        from torch.profiler import profile
        cuda = torch.cuda.is_available()
        with profile(activities=_activities()):
            torch.zeros(1, device="cuda" if cuda else "cpu").add_(1)
            if cuda:
                torch.cuda.synchronize()

    def start(self) -> None:
        self.prof.start()
        self.on = True

    def stop(self) -> None:
        self.prof.stop()
        self.on = False

    def trace(self) -> Trace:
        """The stopped session, reduced (after the window: the reduction
        takes seconds)."""
        return Trace(self.prof.profiler.kineto_results.events(), self.marks)

    def range(self, name: str):
        """A host range ``bench.<name>`` (marked while tracing)."""
        import time
        from torch.profiler import record_function
        if self.on:
            self.marks.append((f"bench.{name}", time.perf_counter()))
        return record_function(f"bench.{name}")
