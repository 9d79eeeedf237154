"""Serve traffic for the port's engines: the mixed workload of
``repro/serve/workload.py`` (staggered arrivals, uneven prompt/output
lengths) and its shared-prefix workload (system-prompt templates).  With slot isolation a request's greedy output depends only on
its own prompt, so outputs are schedule-independent: the same request set
decodes identically under any arrival pattern, any ticks_per_sync and
under ``EngineReference``.  The same seed gives the same requests as the
JAX package's ``mixed_requests`` and ``shared_prefix_requests``.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

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
