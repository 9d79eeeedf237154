"""Serve traffic for the port's engines (torch counterpart of
``repro/serve/workload.py``): the mixed workload (staggered arrivals,
uneven prompt/output lengths), the shared-prefix workload (system-prompt
templates), and generated traffic: Poisson arrivals, optionally
burst-modulated, in the engine's tick domain, with lognormal prompt and
output lengths, driven by arrival time (``run_arrivals``).  With slot
isolation a request's greedy output depends only on its own prompt, so
outputs are schedule-independent: the same request set decodes
identically under any arrival pattern, any ticks_per_sync and under
``EngineReference``.  Everything is drawn from ``np.random.default_rng``
in the JAX package's order, so the same seed gives the same requests,
arrivals and lengths as its generators, bit for bit.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import Request


def mixed_requests(n: int, *, seed: int = 0, vocab: int = 512,
                   prompt_lens: Tuple[int, int] = (2, 10),
                   max_new: Tuple[int, int] = (3, 10),
                   temperature: float = 0.0,
                   temperature_every: int = 0) -> List[Request]:
    """n requests with uneven prompt/output lengths (inclusive ranges).

    ``temperature_every`` = j > 0 gives every j-th request ``temperature``
    (the rest greedy)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        prompt = [int(t) for t in rng.integers(1, vocab, size=plen)]
        temp = (temperature if temperature_every and
                (i + 1) % temperature_every == 0 else 0.0)
        reqs.append(Request(
            uid=i, prompt=prompt,
            max_new_tokens=int(rng.integers(max_new[0], max_new[1] + 1)),
            temperature=temp))
    return reqs


def run_staggered(engine, groups: Sequence[Sequence[Request]],
                  max_ticks: int = 10_000) -> Dict[int, List[int]]:
    """Submit request groups with one engine step between arrivals, then
    run to completion.  Returns {uid: output tokens}."""
    for i, group in enumerate(groups):
        for r in group:
            engine.submit(r)
        if i + 1 < len(groups):
            engine.step()
    engine.run(max_ticks=max_ticks)
    reqs = [r for g in groups for r in g]
    missing = [r.uid for r in reqs if not r.done]
    if missing:
        raise RuntimeError(f"requests {missing} did not finish "
                           f"within {max_ticks} ticks")
    return {r.uid: list(r.output) for r in reqs}


def staggered_groups(reqs: Sequence[Request],
                     group_size: int) -> List[List[Request]]:
    """Chop a request list into arrival groups of ``group_size``."""
    return [list(reqs[i:i + group_size])
            for i in range(0, len(reqs), group_size)]


def shared_prefix_requests(n: int, *, seed: int = 0, vocab: int = 512,
                           num_templates: int = 4, template_len: int = 42,
                           suffix_lens: Tuple[int, int] = (2, 8),
                           max_new: Tuple[int, int] = (3, 10),
                           temperature: float = 0.0,
                           temperature_every: int = 0) -> List[Request]:
    """n requests over ``num_templates`` shared system-prompt templates:
    request i's prompt is template ``i % num_templates`` of
    ``template_len`` tokens plus a private random suffix (inclusive
    ``suffix_lens`` bounds) — the traffic radix-tree prefix sharing is
    built for.  A ``template_len`` that is not a multiple of the page size
    makes the paged engine copy-on-write a boundary page on every reuse
    (the default 42 % 8 == 6)."""
    if num_templates < 1 or template_len < 1:
        raise ValueError("need >= 1 template of >= 1 token")
    rng = np.random.default_rng(seed)
    templates = [[int(t) for t in rng.integers(1, vocab, size=template_len)]
                 for _ in range(num_templates)]
    reqs = []
    for i in range(n):
        slen = int(rng.integers(suffix_lens[0], suffix_lens[1] + 1))
        suffix = [int(t) for t in rng.integers(1, vocab, size=slen)]
        temp = (temperature if temperature_every and
                (i + 1) % temperature_every == 0 else 0.0)
        reqs.append(Request(
            uid=i, prompt=templates[i % num_templates] + suffix,
            max_new_tokens=int(rng.integers(max_new[0], max_new[1] + 1)),
            temperature=temp))
    return reqs


# ---- Poisson / bursty traffic generation ------------------------------------


def poisson_arrivals(n: int, *, rate: float, rng: np.random.Generator,
                     burst_amp: float = 0.0,
                     burst_period: float = 64.0) -> np.ndarray:
    """n arrival times (float ticks, strictly increasing) from a Poisson
    process with instantaneous rate

        lambda(t) = rate * (1 + burst_amp * sin(2 pi t / burst_period))

    ``burst_amp = 0`` is a homogeneous process (mean inter-arrival gap
    ``1 / rate``); ``0 < burst_amp <= 1`` gives a diurnal/bursty rate that
    swings between ``rate * (1 - amp)`` and ``rate * (1 + amp)`` with the
    given period.  Sampled exactly by Lewis–Shedler thinning of a
    homogeneous process at the peak rate.
    """
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    if not 0.0 <= burst_amp <= 1.0:
        raise ValueError(f"burst_amp must be in [0, 1], got {burst_amp}")
    if burst_amp > 0 and burst_period <= 0:
        raise ValueError(f"burst_period must be > 0, got {burst_period}")
    lam_max = rate * (1.0 + burst_amp)
    out, t = [], 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / lam_max)
        lam_t = rate * (1.0 + burst_amp
                        * math.sin(2.0 * math.pi * t / burst_period))
        if rng.random() * lam_max <= lam_t:
            out.append(t)
    return np.asarray(out, np.float64)


def lognormal_lengths(n: int, *, rng: np.random.Generator, log_mean: float,
                      sigma: float, bounds: Tuple[int, int]) -> np.ndarray:
    """n heavy-tailed integer lengths: round(lognormal(log_mean, sigma))
    clipped to the inclusive ``bounds`` — the standard stand-in for real
    prompt/output length distributions (a few giants, many shorts)."""
    lo, hi = bounds
    if not 1 <= lo <= hi:
        raise ValueError(f"bad length bounds {bounds}")
    raw = np.round(rng.lognormal(log_mean, sigma, size=n))
    return np.clip(raw, lo, hi).astype(np.int64)


def poisson_requests(n: int, *, seed: int = 0, vocab: int = 512,
                     arrival_rate: float = 0.25, burst_amp: float = 0.0,
                     burst_period: float = 64.0,
                     prompt_bounds: Tuple[int, int] = (2, 32),
                     prompt_log_mean: float = 2.0,
                     prompt_sigma: float = 0.6,
                     new_bounds: Tuple[int, int] = (1, 16),
                     new_log_mean: float = 1.4, new_sigma: float = 0.7,
                     temperature: float = 0.0,
                     temperature_every: int = 0,
                     deadline_ticks: Optional[float] = None) -> List[Request]:
    """n requests with Poisson/bursty tick-domain arrivals (``.arrival``)
    and lognormal prompt / output-budget lengths.  Seeded and fully
    reproducible; uids follow arrival order.  ``deadline_ticks`` gives
    every request an absolute deadline ``arrival + deadline_ticks`` —
    the engines' ShedPolicy then sheds or times out work that cannot
    meet it."""
    rng = np.random.default_rng(seed)
    arrivals = poisson_arrivals(n, rate=arrival_rate, rng=rng,
                                burst_amp=burst_amp,
                                burst_period=burst_period)
    plens = lognormal_lengths(n, rng=rng, log_mean=prompt_log_mean,
                              sigma=prompt_sigma, bounds=prompt_bounds)
    nnew = lognormal_lengths(n, rng=rng, log_mean=new_log_mean,
                             sigma=new_sigma, bounds=new_bounds)
    reqs = []
    for i in range(n):
        prompt = [int(t) for t in rng.integers(1, vocab, size=int(plens[i]))]
        temp = (temperature if temperature_every and
                (i + 1) % temperature_every == 0 else 0.0)
        reqs.append(Request(
            uid=i, prompt=prompt, max_new_tokens=int(nnew[i]),
            temperature=temp, arrival=float(arrivals[i]),
            deadline=(None if deadline_ticks is None
                      else float(arrivals[i]) + float(deadline_ticks))))
    return reqs


def run_arrivals(engine, reqs: Sequence[Request],
                 max_ticks: int = 100_000,
                 strict: bool = True) -> Dict[int, List[int]]:
    """Drive ``engine`` by per-request arrival times instead of fixed
    groups: each request is submitted at the first host sync point whose
    tick clock has reached its ``arrival`` (requests without one arrive
    at tick 0).  When the engine goes idle before the next arrival, the
    tick clock fast-forwards to it — idle ticks decode nothing but still
    count against ``max_ticks``.  Returns {uid: output tokens}; with
    ``strict`` (default) raises if any request failed to reach a
    terminal state in budget (shed / timed-out / failed requests ARE
    terminal: admission control resolving a request is a served
    outcome, not a hang).
    """
    order = sorted(reqs, key=lambda r: (r.arrival or 0.0, r.uid))
    pending = collections.deque(order)
    start = engine.ticks
    k = engine.ticks_per_sync
    while True:
        while pending and (pending[0].arrival or 0.0) <= engine.ticks:
            engine.submit(pending.popleft())
        if engine._queue or any(r is not None for r in engine.slot_req):
            if engine.ticks - start + k > max_ticks:
                break
            n = engine.step()
            if n == 0 and engine._queue and engine._last_admitted == 0:
                # resource stall (nothing active, nothing admissible):
                # advance the clock so deadlines expire and the budget
                # check terminates the loop — never spin forever
                engine.ticks += k
        elif pending:
            nxt = max(engine.ticks, int(math.ceil(pending[0].arrival or 0.0)))
            if nxt - start > max_ticks:
                break
            engine.ticks = nxt   # idle fast-forward to the next arrival
        else:
            break
    stuck = [r for r in reqs if not r.terminal]
    if strict and stuck:
        hist = collections.Counter(r.state for r in reqs)
        missing = sorted(r.uid for r in stuck)
        raise RuntimeError(f"requests {missing} did not finish "
                           f"within {max_ticks} ticks "
                           f"(terminal states: {dict(hist)})")
    return {r.uid: list(r.output) for r in reqs if r.done}
