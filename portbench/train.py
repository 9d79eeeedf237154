"""Train cells: the port's ``TrainWindow`` on the benchmark's weights.

Set-up builds one train state (the weights, AdamW's state, the step) and
one window, and drives that same window from the seed through its first
steps: a call of 1 step, then a call of 2 (the window's own call and its
own on-card rows), reading the first gradient from AdamW's first moment
after step 1 and each weight's change after step 3; then one more call of
``steps_per_sync`` steps warms the rest.  The window runs whole calls of
``steps_per_sync`` steps until ``seconds`` have passed; ``train_tok_s`` is
the tokens of those steps over their seconds.

``correct``: the float32 reference follows the first three steps from the
same weights on the same rows (worked out again) and the run's losses,
first gradients and changes are held to it (``compare``)."""
from __future__ import annotations

import contextlib
import math
import time
from typing import Dict, List

import torch

from portbench import weights


def run(ctx) -> dict:
    from repro_torch.data import DataConfig
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train.trainer import TrainWindow
    from portbench.cell import port_config

    cell, A, dev = ctx.cell, ctx.arch, ctx.device
    wl, mix = cell["workload"], cell["traffic"]
    rec = wl["recipe"]
    model = build_model(port_config(A, cell["config"]["name"],
                                    remat=wl["remat"]),
                        max_seq=mix["seq"], device=dev)
    W = weights.make(A, ctx.seed, dev)
    weights.check_layout(A, model.param_defs)
    opt = AdamW(lr=warmup_cosine(rec["lr"], rec["warmup"], rec["total"]))
    state = {"params": W, "opt": opt.init(W),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    dcfg = DataConfig(A["V"], mix["seq"], mix["batch"],
                      seed=ctx.seed & 0xFFFFFFFF)
    win = TrainWindow(model, opt, dcfg, steps_per_sync=wl["steps_per_sync"],
                      microbatches=wl["microbatches"],
                      attn_impl=wl["attn_impl"], record_traffic=False)
    ctx.plant(win)
    K = wl["steps_per_sync"]
    names = sorted(W)
    b1 = opt.b1

    # the first three steps, through the window's own call
    win.steps_per_sync = 1
    state, m1 = win(state)
    grad = {n: float(torch.linalg.vector_norm(state["opt"]["m"][n]))
            / (1 - b1) for n in names}
    win.steps_per_sync = 2
    state, m2 = win(state)
    losses = torch.cat([m1["loss"], m2["loss"]]).tolist()
    W0 = weights.make(A, ctx.seed, dev)
    change = {n: float(torch.linalg.vector_norm(
        state["opt"]["master"][n] - W0[n].float())) for n in names}
    del W0
    win.steps_per_sync = K
    state, m = win(state)
    m["loss"].tolist()
    prof = ctx.profiler() if ctx.trace else None
    if prof is not None:
        prof.warm()
    ctx.sync()
    setup_s = ctx.since_start()

    calls: List[dict] = []
    t_open = time.perf_counter()
    while True:
        profiled = prof is not None and len(calls) < wl["trace_calls"]
        if profiled and not prof.on:
            prof.start()
        t0 = time.perf_counter()
        with (prof.range("window") if prof is not None
              else contextlib.nullcontext()):
            state, m = win(state)
            loss = m["loss"].tolist()
        t1 = time.perf_counter()
        calls.append({"ts": t0, "t0": t0, "t1": t1, "steps": K, "loss": loss,
                      "profiled": profiled})
        if prof is not None and prof.on and len(calls) == wl["trace_calls"]:
            prof.stop()
        if t1 - t_open >= ctx.seconds:
            break
    window = calls[-1]["t1"] - t_open
    ctx.sync()
    peak = ctx.memory_peak()
    if prof is not None and prof.on:
        prof.stop()
    trace = prof.trace() if prof is not None else None
    steps = sum(c["steps"] for c in calls)
    bad = sum(1 for c in calls for x in c["loss"] if not math.isfinite(x))
    tokens_per_step = mix["batch"] * mix["seq"]
    result = {"attempted": steps, "failed": bad, "memory_peak_bytes": peak}
    if ctx.trace:
        result["per_layer"] = {"kind": "train", "arch": A, "workload": wl,
                               "traffic": mix, "trace": trace,
                               "calls": calls}
    else:
        result["end_to_end"] = {"train_tok_s": steps * tokens_per_step
                                / window, "setup_s": setup_s}
    del state, win, model, W, m, m1, m2
    ctx.free()
    result["program"] = {"loss": losses, "grad": grad, "change": change}
    return result


def recipe(ctx) -> dict:
    wl, mix = ctx.cell["workload"], ctx.cell["traffic"]
    return dict(wl["recipe"], batch=mix["batch"], seq=mix["seq"],
                microbatches=wl["microbatches"])


def compare(ref: dict, prog: dict, where: dict = None) -> Dict[str, float]:
    """The three numbers held to limits, each the worst over its parts:

    - ``loss``: |loss - reference loss| / reference loss over steps 1-3;
    - ``grad``: over the weights, the gap between the norms of the run's
      and the reference's first clipped gradient, over the larger of the
      reference's norm of that weight and the median weight's;
    - ``change``: the same of each weight's change after step 3, over the
      weights whose reference gradient is at least a thousandth of the
      median weight's (the others, such as a key bias under softmax, have
      no gradient but round-off, which AdamW turns into full steps).

    ``where``, when given, receives the worst step and weights and the
    weights left out of ``change``."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    g_med = _median(ref["grad"].values())
    grad = {n: abs(prog["grad"][n] - g) / max(g, g_med)
            for n, g in ref["grad"].items()}
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * g_med]
    c_med = _median(ref["change"][n] for n in moved)
    change = {n: abs(prog["change"][n] - ref["change"][n])
              / max(ref["change"][n], c_med) for n in moved}
    if where is not None:
        where.update(loss_step=gaps.index(max(gaps)) + 1,
                     grad_weight=max(grad, key=grad.get),
                     change_weight=max(change, key=change.get),
                     left_out=sorted(set(ref["grad"]) - set(moved)))
    return {"loss": max(gaps), "grad": max(grad.values()),
            "change": max(change.values())}


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def reference(ctx, num=None, rows=None) -> dict:
    """The reference's three steps from the seed's weights."""
    from portbench.reference import train as ref_train
    W0 = weights.make(ctx.arch, ctx.seed, ctx.device)
    out = ref_train.run(ctx.arch, W0, recipe(ctx), ctx.seed & 0xFFFFFFFF,
                        steps=3, num=num, rows=rows)
    del W0
    ctx.free()
    return out


def check(ctx, result) -> dict:
    lim = ctx.cell["workload"]["check"]
    nums = compare(reference(ctx), result["program"])
    return {k: {"value": v, "limit": lim[k]} for k, v in nums.items()}
