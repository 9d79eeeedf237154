"""Serve cells: a closed loop of clients against the port's ``Engine``.

Set-up builds the engine on the benchmark's weights, then runs the loop
for the mix's fixed number of warm-up steps, the clients joining
``ramp`` at a time (the first steps prefill the widest waves the traffic
makes and fill the slots), so that the window opens on a full engine.
The window then runs whole engine steps (admission, a decode window, the
drain) until ``seconds`` have passed.  The harness stamps each request on
its own clock: sent before ``Engine.submit``, first token and done when
``step`` returns with them.

End to end: ``decode_tok_s`` (output tokens seen in the window over its
seconds), ``ttft_p95_ms`` (sent to first token, over the requests whose
first token came in the window), ``tpot_p95_ms`` ((done - first token) /
(tokens - 1) over the requests done in the window), ``setup_s``.

With ``--trace 1`` the first ``trace_steps`` steps of the window run under
the profiler and the engine carries a ``Tracer``; the per-layer readers
take the profiled steps' trace and the other steps' spans and work.

``correct``: once the window has closed and the engine is freed, two
samples drawn from the seed of the requests done in the window (each with
the longest of its kind) run through the float32 reference over prompt +
output.  Of the greedy ones, the widest gap by which a served token's
logit lies below the reference's best logit at its position
(``logit_gap``); of the sampled ones, how far the served tokens' places
in the reference's tempered distributions stray from uniform
(``sample_z``, see ``sampled_z``).  Each is held to the cell's limit.

Python's garbage collector is frozen and off through the window (the
objects of set-up moved to the permanent generation), so that a
collection of the harness's request objects lands in no step."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import generator
from portbench import weights


@dataclasses.dataclass
class Sent:
    """One request as the harness sees it."""
    req: object
    prompt_len: int
    temperature: float
    sent: float
    seen: int = 0
    first: Optional[float] = None
    done: Optional[float] = None
    state: Optional[str] = None


@dataclasses.dataclass
class Step:
    """One engine step: its host stamps (``ts`` before the clients send,
    ``t0`` / ``t1`` around ``Engine.step``) and, for each request that
    gained tokens, (prompt length, tokens seen before, tokens seen
    after)."""
    ts: float
    t0: float
    t1: float
    work: List[tuple]
    profiled: bool = False


class ClosedLoop:
    def __init__(self, engine, stream, clients: int, request_cls, prof=None):
        self.eng, self.stream, self.clients = engine, stream, clients
        self.request_cls = request_cls
        self.joined = 0
        self.live: Dict[int, Sent] = {}
        self.sent: List[Sent] = []
        self.uid = 0
        self.prof = prof

    def _range(self, name):
        return (self.prof.range(name) if self.prof is not None
                else contextlib.nullcontext())

    def step(self, join: int = 0) -> Step:
        self.joined = min(self.clients, self.joined + join)
        ts = time.perf_counter()
        with self._range("clients"):
            for c in range(self.joined):
                if c in self.live:
                    continue
                tokens, max_new, temp = self.stream.next()
                req = self.request_cls(uid=self.uid, prompt=tokens,
                                       max_new_tokens=max_new,
                                       temperature=temp)
                self.uid += 1
                s = Sent(req, len(tokens), temp, time.perf_counter())
                self.live[c] = s
                self.sent.append(s)
                self.eng.submit(req)
        t0 = time.perf_counter()
        with self._range("step"):
            self.eng.step()
        t1 = time.perf_counter()
        work = []
        for c, s in list(self.live.items()):
            n = len(s.req.output)
            if n > s.seen:
                work.append((s.prompt_len, s.seen, n))
                if s.seen == 0:
                    s.first = t1
                s.seen = n
            if s.req.terminal:
                s.done, s.state = t1, s.req.state
                del self.live[c]
        return Step(ts, t0, t1, work)


def pct(xs, q: float) -> float:
    """Linear-interpolation percentile (numpy's default), the port's
    ``telemetry.percentile`` arithmetic."""
    xs = sorted(xs)
    rank = (len(xs) - 1) * q / 100.0
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (rank - lo) * (xs[hi] - xs[lo])


def run(ctx) -> dict:
    from repro_torch.models import build_model
    from repro_torch.serve import DONE, Engine, Request, Tracer
    from portbench.cell import port_config

    cell, A, dev = ctx.cell, ctx.arch, ctx.device
    wl, mix = cell["workload"], cell["traffic"]
    ekw = dict(wl["engine"])
    model = build_model(port_config(A, cell["config"]["name"]),
                        max_seq=ekw["max_len"], device=dev)
    W = weights.make(A, ctx.seed, dev)
    weights.check_layout(A, model.param_defs)
    prof = ctx.profiler() if ctx.trace else None
    tracer = Tracer() if ctx.trace else None
    eng = Engine(model, W, seed=ctx.seed & 0xFFFFFFFF,
                 record_traffic=False, device=dev, tracer=tracer, **ekw)
    ctx.plant(eng)
    loop = ClosedLoop(eng, generator.RequestStream(mix, A["V"], ctx.seed),
                      mix["clients"], Request, prof)
    for _ in range(mix["warmup_steps"]):
        loop.step(join=mix["ramp"])
    if prof is not None:
        prof.warm()
    ctx.sync()
    setup_s = ctx.since_start()

    steps: List[Step] = []
    gc.collect()
    gc.freeze()
    gc.disable()
    t_open = time.perf_counter()
    # the Tracer's recorded spans (its list; the warm-up's are left out)
    n_spans0 = len(tracer._spans) if tracer is not None else 0
    while True:
        profiled = prof is not None and len(steps) < wl["trace_steps"]
        if profiled and not prof.on:
            prof.start()
        st = loop.step(join=mix["clients"])
        st.profiled = profiled
        steps.append(st)
        if prof is not None and prof.on and len(steps) == wl["trace_steps"]:
            prof.stop()
        if st.t1 - t_open >= ctx.seconds:
            break
    t_close = steps[-1].t1
    window = t_close - t_open
    gc.enable()
    gc.unfreeze()
    ctx.sync()
    peak = ctx.memory_peak()
    if prof is not None and prof.on:
        prof.stop()
    trace = prof.trace() if prof is not None else None

    inside = [s for s in loop.sent
              if s.first is not None and t_open < s.first <= t_close]
    done = [s for s in loop.sent
            if s.done is not None and t_open < s.done <= t_close]
    attempted = [s for s in loop.sent if s.sent <= t_close
                 and (s.done is None or s.done > t_open)]
    failed = [s for s in attempted
              if s.done is not None and s.state != DONE]
    tokens = sum(new - old for st in steps for _, old, new in st.work)
    ttft = [(s.first - s.sent) * 1e3 for s in inside]
    ttft += [float("inf")] * sum(1 for s in failed if s.first is None)
    tpot = [(s.done - s.first) * 1e3 / (s.seen - 1) for s in done
            if s.state == DONE and s.seen > 1]

    result = {"attempted": len(attempted), "failed": len(failed),
              "memory_peak_bytes": peak}
    if ctx.trace:
        spans = tracer._spans[n_spans0:]
        result["per_layer"] = {"kind": "serve", "arch": A, "workload": wl,
                               "trace": trace, "steps": steps,
                               "spans": spans, "ticks": ekw["ticks_per_sync"]}
    else:
        result["end_to_end"] = {
            "decode_tok_s": tokens / window,
            "ttft_p95_ms": pct(ttft, 95) if ttft else float("inf"),
            "tpot_p95_ms": pct(tpot, 95) if tpot else float("inf"),
            "setup_s": setup_s}

    # ---- correctness: the engine's state goes before the reference runs
    ok = [s for s in done if s.state == DONE]
    greedy = [(list(s.req.prompt), list(s.req.output)) for s in ok
              if s.temperature == 0.0]
    sampled = [(list(s.req.prompt), list(s.req.output), s.temperature)
               for s in ok if s.temperature > 0.0]
    del eng, loop, model, inside, done, attempted, ok
    ctx.free()
    chk = wl["check"]
    result["sample"] = pick_sample(greedy, chk["tokens"],
                                   chk["max_requests"], ctx.seed)
    result["sampled"] = pick_sample(sampled, chk["sampled_tokens"],
                                    chk["sampled_requests"], ctx.seed + 1)
    result["weights"] = W
    return result


def pick_sample(served, tokens: int, max_requests: int, seed: int):
    """The requests the check reads: the longest served one (prompt +
    output), then others drawn from the seed until ``tokens`` served
    tokens or ``max_requests`` requests."""
    if not served:
        return []
    order = sorted(range(len(served)),
                   key=lambda i: -(len(served[i][0]) + len(served[i][1])))
    rng = np.random.default_rng([int(seed), 0xC4EC])
    rest = list(rng.permutation(order[1:])) if len(order) > 1 else []
    picked, n = [], 0
    for i in [order[0]] + rest:
        picked.append(served[i])
        n += len(served[i][1])
        if n >= tokens or len(picked) >= max_requests:
            break
    return picked


def served_gaps(arch: dict, W, sample, device, num=None, rank_num=None):
    """For each served token of each sampled request: the reference's
    best logit at its position minus the reference's logit of the token.
    With ``rank_num`` the token is not the served one but the one that
    ``rank_num``'s arithmetic puts first (the control's reading).
    Returns the widest gap."""
    import torch
    from portbench.reference.decoder import sequence_logits
    worst = 0.0
    for prompt, out in sample:
        seq, at = _positions(prompt, out, device)
        ref = sequence_logits(arch, W, seq, at, num)
        if rank_num is None:
            tok = torch.tensor(out, device=device)
        else:
            tok = sequence_logits(arch, W, seq, at, rank_num).argmax(-1)
        gap = ref.max(-1).values - ref.gather(1, tok[:, None].long())[:, 0]
        worst = max(worst, float(gap.max()))
        del ref
    return worst


def _positions(prompt, out, device):
    import torch
    seq = torch.tensor(prompt + out[:-1], device=device)
    at = torch.arange(len(prompt) - 1, len(prompt) + len(out) - 1,
                      device=device)
    return seq, at


def places(ref, tok, temperature: float, gen):
    """Each token's place in its position's tempered reference
    distribution p = softmax(ref / temperature) (float64): the mass of the
    tokens whose reference logit is higher, plus a uniform share, drawn
    from ``gen``, of the token's own.  A token drawn from p has a place
    uniform on (0, 1), whatever p is."""
    import torch
    ref = ref.double()
    p = torch.softmax(ref / temperature, dim=-1)
    own = ref.gather(1, tok[:, None].long())
    above = (p * (ref > own)).sum(-1)
    u = torch.rand(tok.shape[0], generator=gen, device=ref.device,
                   dtype=torch.float64)
    return above + u * p.gather(1, tok[:, None].long())[:, 0]


def z_of(u) -> float:
    """|mean - 1/2| of n places in units of its standard error under
    uniform places, sqrt(1 / (12 n))."""
    n = len(u)
    if n == 0:
        return float("inf")
    return abs(float(sum(u)) / n - 0.5) * math.sqrt(12.0 * n)


def sampled_z(arch: dict, W, sampled, device, seed: int,
              draws=None) -> dict:
    """``sample_z`` of the sampled requests: their served tokens' places
    (``places``) in the float32 reference's distributions at each
    request's temperature, pooled, as ``z_of``.  A sampler that draws
    from the right distribution reads like the absolute value of a
    standard normal; a wrong temperature, a greedy pick or an altered
    token move the mean place and read far higher.

    ``draws`` {name: f(ref logits, tokens, temperature, gen, seq, at) ->
    tokens} adds readings of tokens drawn in the program's place at the
    same positions (the control and the planted faults)."""
    import torch
    from portbench.reference.decoder import sequence_logits
    names = ["program"] + list(draws or {})
    gens = {n: torch.Generator(device=device) for n in names}
    for i, n in enumerate(names):
        gens[n].manual_seed((int(seed) * 7919 + 0x5A3 + i) & (2 ** 63 - 1))
    pool = {n: [] for n in names}
    for prompt, out, temp in sampled:
        seq, at = _positions(prompt, out, device)
        ref = sequence_logits(arch, W, seq, at)
        served = torch.tensor(out, device=device)
        pool["program"] += places(ref, served, temp,
                                  gens["program"]).tolist()
        for n, draw in (draws or {}).items():
            tok = draw(ref, served, temp, gens[n], seq, at)
            pool[n] += places(ref, tok, temp, gens[n]).tolist()
        del ref
    return {n: z_of(u) for n, u in pool.items()}


def check(ctx, result) -> dict:
    """The correctness numbers of a run, each with its limit."""
    lim = ctx.cell["workload"]["check"]
    gap = (served_gaps(ctx.arch, result["weights"], result["sample"],
                       ctx.device) if result["sample"] else float("inf"))
    z = sampled_z(ctx.arch, result["weights"], result["sampled"],
                  ctx.device, ctx.seed)["program"]
    return {"logit_gap": {"value": gap, "limit": lim["logit_gap"]},
            "sample_z": {"value": z, "limit": lim["sample_z"]}}
