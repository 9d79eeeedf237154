"""The general traffic generator: every mix is a data file under
``traffic/`` read here.

Serve mixes (``"kind": "closed_loop"``): ``clients`` clients each keep one
request outstanding and send the next as soon as the last one ends.
Prompt and output lengths are lognormal (``median``, ``sigma``, clipped to
``min``..``max``), drawn as the ``pool`` stratified quantiles of that
law, so that every seed serves the same set of sizes in another order:
each pass over the pool is a fresh permutation of the prompt lengths and,
independently, of the output lengths, drawn from the seed.  Token ids are
uniform over the vocabulary; every ``temperature.every``-th request
samples at ``temperature.value``, the others are greedy.

Training mixes (``"kind": "train"``) give the batch rows and sequence
length; the rows themselves are the program's counter-hashed stream for
the seed (``reference/data.py`` works them out again)."""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List

import numpy as np


def stratified_lengths(spec: dict, n: int) -> np.ndarray:
    """The n quantiles (i + 1/2) / n of lognormal(log median, sigma),
    rounded and clipped to [min, max]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    raw = np.round(np.exp(math.log(spec["median"]) + spec["sigma"] * z))
    return np.clip(raw, spec["min"], spec["max"]).astype(np.int64)


class RequestStream:
    """The endless request sequence of a closed-loop mix for one seed:
    ``next()`` gives (prompt token ids, max new tokens, temperature)."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        if mix["kind"] != "closed_loop":
            raise ValueError(f"not a closed-loop mix: {mix['kind']!r}")
        self.mix = mix
        self.vocab = int(vocab)
        self.rng = np.random.default_rng([int(seed), 0x7AFF1C])
        self.prompts = stratified_lengths(mix["prompt"], mix["pool"])
        self.outputs = stratified_lengths(mix["output"], mix["pool"])
        self.count = 0
        self._cycle: List[tuple] = []

    def _refill(self) -> None:
        p = self.rng.permutation(self.prompts)
        o = self.rng.permutation(self.outputs)
        self._cycle = list(zip(p.tolist(), o.tolist()))[::-1]

    def next(self):
        if not self._cycle:
            self._refill()
        plen, olen = self._cycle.pop()
        tokens = self.rng.integers(0, self.vocab, size=plen).tolist()
        temp = self.mix["temperature"]
        t = (float(temp["value"]) if temp["every"]
             and self.count % temp["every"] == temp["every"] - 1 else 0.0)
        self.count += 1
        return tokens, int(olen), t
