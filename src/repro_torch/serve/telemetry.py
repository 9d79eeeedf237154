"""Per-request latency percentiles (the latency-accounting half of
``repro/serve/telemetry.py``; the chrome-trace exporter is not ported
yet).

TTFT is first_token − submit, TPOT is (done − first_token) / (tokens − 1)
for multi-token outputs, E2E is done − submit; each in the tick and the
wall-clock domain.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

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
    if the request has not finished."""
    if not (req.done and req.done_time is not None
            and req.first_token_time is not None
            and req.submit_time is not None):
        return None
    n = len(req.output)
    wall = {"ttft_s": req.first_token_time - req.submit_time,
            "e2e_s": req.done_time - req.submit_time}
    ref = req.submit_tick
    ticks = {"ttft": req.first_token_tick - ref, "e2e": req.done_tick - ref}
    if n > 1:
        wall["tpot_s"] = (req.done_time - req.first_token_time) / (n - 1)
        ticks["tpot"] = (req.done_tick - req.first_token_tick) / (n - 1)
    return {"wall": wall, "ticks": ticks}


def latency_summary(reqs: Iterable[Request],
                    qs: Sequence[float] = PERCENTILES) -> dict:
    """TTFT/TPOT/E2E percentiles over finished requests: {"n",
    "completed", "tokens", "states", "wall": {metric: summarize()},
    "ticks": {...}}; unfinished requests count in ``n`` only."""
    reqs = list(reqs)
    finished = [lat for lat in map(request_latency, reqs) if lat is not None]
    states: Dict[str, int] = {}
    for r in reqs:
        states[r.state] = states.get(r.state, 0) + 1
    out = {"n": len(reqs), "completed": len(finished),
           "tokens": sum(len(r.output) for r in reqs if r.done),
           "states": states, "wall": {}, "ticks": {}}
    for domain in ("wall", "ticks"):
        keys = sorted({k for lat in finished for k in lat[domain]})
        out[domain] = {k: summarize([lat[domain][k] for lat in finished
                                     if k in lat[domain]], qs)
                       for k in keys}
    return out
