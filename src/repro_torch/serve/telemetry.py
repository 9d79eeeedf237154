"""Serve telemetry (torch counterpart of ``repro/serve/telemetry.py``):
per-request latency percentiles and the chrome-trace exporter.

* **Latency accounting.**  ``Request`` carries submit / admit /
  first-token / done stamps in both time domains, engine ticks and wall
  clock (``time.perf_counter``).  TTFT is first_token − reference, TPOT is
  (done − first_token) / (tokens − 1) for multi-token outputs, E2E is
  done − reference; the tick-domain reference is the request's intended
  ``arrival`` when a traffic generator set one, else its submit tick (the
  wall-clock one is always the submit stamp).  ``latency_summary`` gives
  p50/p95/p99 (+ mean/max) of each, over the requests that ended DONE,
  with the terminal-state histogram beside them.

* **Chrome-trace export.**  ``Tracer`` collects the engines' spans —
  batched prefill calls, decode windows, host drains, the paged engine's
  admission with its copy-on-write and page-gather instants — and an
  active-slots counter, and writes Trace Event JSON (``chrome://tracing``
  / Perfetto; microsecond timestamps).  The spans measure what the host
  observes: a decode window ends when its one host transfer returns, and
  nothing is synchronised to time it.  Engines call the tracer only when
  one is attached.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.serve.engine import Request

PERCENTILES = (50.0, 95.0, 99.0)


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default method)."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    xs = sorted(float(x) for x in xs)
    if not xs:
        raise ValueError("percentile of an empty sequence")
    rank = (len(xs) - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (rank - lo) * (xs[hi] - xs[lo])


def summarize(xs: Sequence[float],
              qs: Sequence[float] = PERCENTILES) -> Dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ..., "mean": ..., "max": ...}."""
    xs = [float(x) for x in xs]
    if not xs:
        return {}
    out = {f"p{q:g}": percentile(xs, q) for q in qs}
    out["mean"] = sum(xs) / len(xs)
    out["max"] = max(xs)
    return out


def request_latency(req: Request) -> Optional[Dict[str, Dict[str, float]]]:
    """Per-request {wall: {ttft_s, tpot_s?, e2e_s}, ticks: {...}} or None
    if the request has not finished DONE."""
    if not (req.done and req.done_time is not None
            and req.first_token_time is not None
            and req.submit_time is not None):
        return None
    n = len(req.output)
    wall = {"ttft_s": req.first_token_time - req.submit_time,
            "e2e_s": req.done_time - req.submit_time}
    ref = req.arrival if req.arrival is not None else req.submit_tick
    ticks = {"ttft": req.first_token_tick - ref, "e2e": req.done_tick - ref}
    if n > 1:
        wall["tpot_s"] = (req.done_time - req.first_token_time) / (n - 1)
        ticks["tpot"] = (req.done_tick - req.first_token_tick) / (n - 1)
    return {"wall": wall, "ticks": ticks}


def latency_summary(reqs: Iterable[Request],
                    qs: Sequence[float] = PERCENTILES) -> dict:
    """TTFT/TPOT/E2E percentiles over finished requests: {"n",
    "completed", "tokens", "states", "shed", "timed_out", "failed",
    "retries", "preemptions", "wall": {metric: summarize()}, "ticks":
    {...}}; requests that did not end DONE count in ``n`` and ``states``
    only."""
    reqs = list(reqs)
    finished = [(r, lat) for r, lat in ((r, request_latency(r))
                                        for r in reqs) if lat is not None]
    states: Dict[str, int] = {}
    for r in reqs:
        states[r.state] = states.get(r.state, 0) + 1
    out = {"n": len(reqs), "completed": len(finished),
           "tokens": sum(len(r.output) for r, _ in finished),
           "states": states,
           "shed": states.get("SHED", 0),
           "timed_out": states.get("TIMED_OUT", 0),
           "failed": states.get("FAILED", 0),
           "retries": sum(r.retries for r in reqs),
           "preemptions": sum(r.preemptions for r in reqs),
           "wall": {}, "ticks": {}}
    for domain in ("wall", "ticks"):
        keys = sorted({k for _, lat in finished for k in lat[domain]})
        out[domain] = {k: summarize([lat[domain][k] for _, lat in finished
                                     if k in lat[domain]], qs)
                       for k in keys}
    return out


# ---- chrome://tracing export ------------------------------------------------

_REQUIRED_BY_PHASE = {"X": ("name", "ts", "dur", "pid", "tid"),
                      "B": ("name", "ts", "pid", "tid"),
                      "E": ("ts", "pid", "tid"),
                      "i": ("name", "ts", "pid"),
                      "C": ("name", "ts", "pid"),
                      "M": ("name", "pid")}


class Tracer:
    """Collects engine spans/counters; exports Trace Event Format JSON.

    Wall-clock inputs are ``time.perf_counter`` seconds; the exporter
    rebases them onto the first recorded event and converts to the
    microsecond ``ts``/``dur`` the trace viewers expect.
    """

    def __init__(self, name: str = "serve-engine"):
        self.name = name
        self._spans: List[dict] = []      # (name, cat, t0, t1, tid, args)
        self._counters: List[dict] = []   # (name, values, t, tid)
        self._nested: List[dict] = []     # "B"/"E" duration events, in order
        self._instants: List[dict] = []   # "i" point events
        self._open: List[dict] = []       # begin() stack awaiting end()

    def span(self, name: str, cat: str, start_s: float, end_s: float,
             tid: int = 0, args: Optional[dict] = None) -> None:
        if end_s < start_s:
            raise ValueError(f"span {name!r}: end {end_s} < start {start_s}")
        self._spans.append({"name": name, "cat": cat, "t0": start_s,
                            "t1": end_s, "tid": tid, "args": args or {}})

    # -- nested spans (paged engine: admit > prefill-chunk > CoW ...) --------

    def begin(self, name: str, cat: str, when_s: float, tid: int = 0,
              args: Optional[dict] = None) -> None:
        """Open a nested span ("B" phase); close with ``end()``.  Unlike
        ``span``, begin/end pairs may enclose other spans and instants —
        the viewer stacks them by arrival order per thread."""
        ev = {"ph": "B", "name": name, "cat": cat, "t": when_s, "tid": tid,
              "args": args or {}}
        self._open.append(ev)
        self._nested.append(ev)

    def end(self, when_s: float, tid: int = 0,
            args: Optional[dict] = None) -> None:
        """Close the innermost open ``begin()`` span ("E" phase)."""
        if not self._open:
            raise ValueError("end() without a matching begin()")
        opened = self._open[-1]
        if when_s < opened["t"]:
            # raise BEFORE popping so a rejected end() leaves the span
            # open instead of orphaning its "B" event in the trace
            raise ValueError(
                f"span {opened['name']!r}: end {when_s} < begin "
                f"{opened['t']}")
        self._open.pop()
        self._nested.append({"ph": "E", "name": opened["name"],
                             "cat": opened["cat"], "t": when_s, "tid": tid,
                             "args": args or {}})

    def instant(self, name: str, cat: str, when_s: float, tid: int = 0,
                args: Optional[dict] = None) -> None:
        """Point-in-time event ("i" phase) — CoW copies, page gathers."""
        self._instants.append({"name": name, "cat": cat, "t": when_s,
                               "tid": tid, "args": args or {}})

    def counter(self, name: str, values: Dict[str, float], when_s: float,
                tid: int = 0) -> None:
        self._counters.append({"name": name, "values": dict(values),
                               "t": when_s, "tid": tid})

    def _origin(self) -> float:
        times = ([s["t0"] for s in self._spans]
                 + [c["t"] for c in self._counters]
                 + [e["t"] for e in self._nested]
                 + [e["t"] for e in self._instants])
        return min(times) if times else 0.0

    def to_chrome_trace(self) -> dict:
        if self._open:
            raise ValueError(
                f"unclosed begin() spans: "
                f"{[e['name'] for e in self._open]}")
        origin = self._origin()
        us = lambda t: (t - origin) * 1e6   # noqa: E731
        events: List[dict] = [
            {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
             "args": {"name": self.name}},
            {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
             "args": {"name": "engine"}},
        ]
        for s in self._spans:
            events.append({"ph": "X", "name": s["name"], "cat": s["cat"],
                           "ts": us(s["t0"]), "dur": us(s["t1"]) - us(s["t0"]),
                           "pid": 0, "tid": s["tid"], "args": s["args"]})
        for e in self._nested:   # emitted in call order (B/E pairing)
            events.append({"ph": e["ph"], "name": e["name"], "cat": e["cat"],
                           "ts": us(e["t"]), "pid": 0, "tid": e["tid"],
                           "args": e["args"]})
        for e in self._instants:
            events.append({"ph": "i", "name": e["name"], "cat": e["cat"],
                           "ts": us(e["t"]), "pid": 0, "tid": e["tid"],
                           "s": "t", "args": e["args"]})
        for c in self._counters:
            events.append({"ph": "C", "name": c["name"], "ts": us(c["t"]),
                           "pid": 0, "tid": c["tid"], "args": c["values"]})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.serve.telemetry"}}

    def save(self, path) -> Path:
        path = Path(path)
        trace = self.to_chrome_trace()
        validate_chrome_trace(trace)
        path.write_text(json.dumps(trace, indent=1) + "\n")
        return path


def validate_chrome_trace(obj: dict) -> None:
    """Raise ValueError unless ``obj`` is structurally valid Trace Event
    JSON (the subset this exporter emits): a ``traceEvents`` list whose
    events carry a known ``ph``, the per-phase required keys,
    non-negative numeric ``ts``/``dur``, and balanced "B"/"E" nesting
    per (pid, tid) track in list order."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    depth: Dict[tuple, int] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in _REQUIRED_BY_PHASE:
            raise ValueError(f"event {i}: unknown phase {ph!r}")
        missing = [k for k in _REQUIRED_BY_PHASE[ph] if k not in ev]
        if missing:
            raise ValueError(f"event {i} (ph={ph}): missing keys {missing}")
        for k in ("ts", "dur"):
            if k in ev and (not isinstance(ev[k], (int, float))
                            or ev[k] < 0):
                raise ValueError(f"event {i}: {k}={ev[k]!r} must be a "
                                 "non-negative number")
        if ph in ("B", "E"):
            track = (ev.get("pid"), ev.get("tid"))
            d = depth.get(track, 0) + (1 if ph == "B" else -1)
            if d < 0:
                raise ValueError(
                    f"event {i}: 'E' without a matching 'B' on track "
                    f"{track}")
            depth[track] = d
    open_tracks = {t: d for t, d in depth.items() if d}
    if open_tracks:
        raise ValueError(f"unbalanced 'B' spans left open: {open_tracks}")
