"""What the per-layer readers under ``metrics/`` share: the traced run's
profiled and unprofiled stretches and the work the window's steps did,
from the harness's own records (``serve.Step``: for each request that
gained tokens in a step, its prompt length and tokens seen before and
after)."""
from __future__ import annotations

from typing import Iterator, List, Tuple


def profiled(pl: dict) -> list:
    key = "steps" if pl["kind"] == "serve" else "calls"
    return [s for s in pl[key] if _get(s, "profiled")]


def unprofiled(pl: dict) -> Tuple[list, float]:
    """The stretch after the profiler stopped: its steps (or window
    calls) and its seconds on the host clock, from the first one's start
    (``ts``, before its clients send) to the last one's end (0 when there
    is none)."""
    key = "steps" if pl["kind"] == "serve" else "calls"
    items = pl[key]
    n = sum(1 for s in items if _get(s, "profiled"))
    if n == 0 or n >= len(items):
        return [], 0.0
    return items[n:], _get(items[-1], "t1") - _get(items[n], "ts")


def _get(s, name):
    return s[name] if isinstance(s, dict) else getattr(s, name)


def spans_after_profiling(pl: dict, prefix: str) -> List[dict]:
    """Tracer spans named ``prefix``... that began after the last profiled
    step ended (the profiler's overhead is not in them)."""
    prof = profiled(pl)
    t = _get(prof[-1], "t1") if prof else float("-inf")
    return [s for s in pl["spans"] if s["name"].startswith(prefix)
            and s["t0"] >= t]


def admitted(steps) -> Iterator[int]:
    """The prompt length of each request admitted in ``steps`` (its first
    token came from that step's prefill)."""
    for st in steps:
        for plen, old, new in st.work:
            if old == 0 and new > 0:
                yield plen


def decode_rows(steps) -> Iterator[List[int]]:
    """For each decode tick of ``steps`` (one engine step's window is its
    ticks), the live key rows of each request it decoded: a request with m
    tokens before a tick decodes at position prompt + m - 1 and reads
    prompt + m rows."""
    for st in steps:
        per_tick: dict = {}
        for plen, old, new in st.work:
            m0 = max(old, 1)
            for j in range(new - m0):
                per_tick.setdefault(j, []).append(plen + m0 + j)
        for j in sorted(per_tick):
            yield per_tick[j]
