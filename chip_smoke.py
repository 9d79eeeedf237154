#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed as it runs; any failure exits non-zero and prints no
result line:

  0. card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
  1. build: every ``csrc/*.cu`` with nvcc for sm_90a (seconds, ptxas notes);
  2. the serve kernels against their plain PyTorch versions at llama3-8b
     shapes (B=8, H=32, K=8, hd=128, L=1024, ragged positions, V=128256),
     with median times over 50 CUDA-event-timed runs (L2 flushed before
     each);
  3. the LRU cache-simulator kernels (``cache_sim_ladder``, ``cache_sim``)
     against their plain versions at shapes slice C does not reach: a
     whole-octave ladder plus 3 MB at 1:16 scale, 2 traces of 65,536
     accesses, and per-point caches with odd set counts, one set, and 1,
     4 and 16 ways; 0 mismatching counts; the time of one link of the
     longest dependent chain;
  4. slice A: ``Engine`` serving 16 mixed requests with llama3-8b at full
     width and depth (bf16, random weights from a seeded generator),
     checking that no decode window syncs with the host, every request
     ends DONE, logits stay finite and the kernel launch counts are what
     the run implies; then a ``torch.profiler`` trace of one decode window
     (device busy share, kernels by device time);
  5. slice B: llama3-8b at full width, 4 layers, f32: the kernel ``Engine``
     against ``EngineReference`` (plain attention and sampling) on 8
     requests, greedy outputs equal token for token;
  6. slice C, the simulator at full scale: ``simulate_ladder`` over the
     16-rung iso-area ladder (0.5-64 MB with 3 MB, 1:1 scale, 16 ways),
     4 zipf traces of 2**22 accesses over a 256 MB footprint; exactly 1
     ladder and 64 per-point launches; all 64 (trace, rung) counts equal
     bit for bit to the 64 per-point ``simulate_reference`` runs and to
     the plain ladder on the same lines, and at 3 MB on trace 0 to the
     per-point plain version and an OrderedDict LRU carried here; both
     kernels and their plain versions timed at these shapes; then
     ``iso_area(dram_model="trace")`` and ``dram_reduction_curve`` at 1:1
     beside the analytic miss model;
  7. the DeepNVM++ pipeline on the card against the same code on the CPU:
     the quickstart's five steps, ``tune_all()`` and ``paper_profiles()``;
     identical Algorithm-1 selections and iso-area capacities, PPA and
     traffic fields within rel 1e-6;
  8. one JSON line ``{"kernels": [...]}`` with each kernel's launches on
     its slice's run (A for the serve kernels, C for the simulator), error
     against its plain version, time, plain time, bound and the time of
     one PyTorch library call computing the same function (none exists for
     an LRU simulation: null).

The last line is ``{"ok": true, "device": {...}}``.
"""
import collections
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
# int32 outside the tensor cores: 64 int32 lanes per SM against the 128
# float32 lanes behind F32_FLOPS_PER_S, which counts an FMA as 2 flops
INT32_OPS_PER_S = F32_FLOPS_PER_S / 4
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # the JAX tests' bounds
# Gumbel-max rows may flip between two tokens whose scores differ by less
# than this (logf in CUDA and torch.log may differ in the last ulp)
SAMPLE_TIE_REL = 1e-5
RUNS = 50


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def median_ms(fn, runs: int = RUNS, flush=None, warm: int = 3) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` after ``warm``
    untimed calls; ``flush()`` runs before each, outside the timed pair."""
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(runs):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


# ---------------------------------------------------------------- phase 0


def phase_card() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {smi.stdout.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.device_count()} device(s)")
    return {"smi": smi.stdout.strip()}


# ---------------------------------------------------------------- phase 1


def phase_build() -> None:
    from repro_torch.kernels import _build
    secs = _build.build_all()
    print(f"build: {secs:.2f} s for {sorted(_build._libs)}")
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")


# ---------------------------------------------------------------- phase 2


def _decode_inputs(gen, dtype, B=8, H=32, K=8, hd=128, L=1024):
    def r(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).to(dtype)

    pos = torch.tensor([0, 1, 127, 128, 300, 511, 777, L - 1],
                       dtype=torch.int32, device=DEVICE)[:B]
    return (r(B, H, hd), r(B, L, K, hd), r(B, L, K, hd), r(B, K, hd),
            r(B, K, hd), pos)


def _decode_bound(q, k, pos, window, elt):
    """Least time for the fused call: live K/V rows read once, q read, o
    written, new rows read and written; 4*hd flops per live key and head."""
    B, H, hd = q.shape
    K = k.shape[2]
    p = pos.long().cpu()
    lo = (p - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(p)
    live = int((p - lo + 1).sum())
    nbytes = (live * K * hd * 2 * elt + 2 * B * H * hd * elt
              + 4 * B * K * hd * elt + 4 * B)
    flops = 4 * live * H * hd
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def _close(out, want, dtype) -> float:
    err = (out.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    check(not bool(bad.any()), f"max |err| {float(err.max()):.3g} beyond "
          f"atol=rtol={tol}")
    return float(err.max())


def phase_decode_attention(flush) -> dict:
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    main = None
    cases = [("bf16 global fused", torch.bfloat16, 0, 0.0, True),
             ("f32 global fused", torch.float32, 0, 0.0, True),
             ("bf16 window=256 cap=50 fused", torch.bfloat16, 256, 50.0,
              True),
             ("f32 window=256 cap=50 fused", torch.float32, 256, 50.0, True),
             ("bf16 global unfused", torch.bfloat16, 0, 0.0, False)]
    for label, dtype, window, cap, fused in cases:
        q, k, v, nk, nv, pos = _decode_inputs(gen, dtype)
        k0, v0 = k.clone(), v.clone()
        kp, vp, kk, vk = k.clone(), v.clone(), k.clone(), v.clone()
        if fused:
            want = da.decode_attention_fused_plain(q, kp, vp, nk, nv, pos,
                                                   window, logit_cap=cap)
            got = ops.decode_attention_fused(q, kk, vk, nk, nv, pos, window,
                                             logit_cap=cap)
        else:
            want = da.decode_attention_plain(q, kp, vp, pos, window,
                                             logit_cap=cap)
            got = ops.decode_attention(q, kk, vk, pos, window,
                                       logit_cap=cap)
        torch.cuda.synchronize()
        err = _close(got, want, dtype)
        check(torch.equal(kk, kp) and torch.equal(vk, vp),
              f"{label}: cache write-back differs from the plain scatter")
        changed = (kk != k0).any(dim=(2, 3)) | (vk != v0).any(dim=(2, 3))
        allowed = torch.zeros_like(changed)
        if fused:
            allowed[torch.arange(len(pos)), pos.long()] = True
        check(not bool((changed & ~allowed).any()),
              f"{label}: a cache row other than (b, pos[b]) changed")
        print(f"decode_attention {label}: max|err| {err:.3g} vs plain "
              f"(tol {TOL[dtype]}), write-back bitwise")
        if label == "bf16 global fused":
            main = dict(q=q, k=kk, v=vk, nk=nk, nv=nv, pos=pos, err=err)
    q, k, v, nk, nv, pos = (main[n] for n in ("q", "k", "v", "nk", "nv",
                                              "pos"))
    ms = median_ms(lambda: ops.decode_attention_fused(q, k, v, nk, nv, pos,
                                                      0), flush=flush)
    plain_ms = median_ms(lambda: da.decode_attention_fused_plain(
        q, k, v, nk, nv, pos, 0), flush=flush)
    B, H, hd = q.shape
    L = k.shape[1]
    mask = (torch.arange(L, device=DEVICE)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    library_ms = median_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, enable_gqa=True), flush=flush)
    bound_ms, bound_by = _decode_bound(q, k, pos, 0, q.element_size())
    print(f"decode_attention bf16 B=8 H=32 K=8 hd=128 L=1024: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms,"
          f" bound {bound_ms:.5f} ms ({bound_by})")
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:73",
            "max_abs_err": main["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def phase_sampling(flush) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.kernels import sampling as sm
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    B, V = 8, 128256
    logits = torch.randn(B, V, generator=gen, device=DEVICE) * 3.0
    # ties across the vocab: first occurrence must win on greedy rows
    logits[0, [5, 70000, 128000]] = 100.0
    logits[1, [V - 1, 3]] = 50.0
    temps = torch.tensor([0.0, 0.0, -1.0, 0.0, 0.7, 1.0, 1.3, 0.5],
                         device=DEVICE)
    key = torch.tensor([0x12345678, 0x9ABCDEF0], dtype=torch.int64,
                       device=DEVICE)
    got = ops.fused_sample(logits, temps, key)
    want = sm.fused_sample_plain(logits, temps, key)
    argmax = torch.argmax(logits, dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    greedy = temps <= 0
    check(torch.equal(got[greedy], argmax[greedy]),
          f"greedy rows {got[greedy].tolist()} != torch.argmax "
          f"{argmax[greedy].tolist()}")
    check(int(got[0]) == 5 and int(got[1]) == 3, "first-occurrence ties")
    score = sm.perturbed_logits(logits, temps, key)
    rows = torch.arange(B, device=DEVICE)
    gap = (score[rows, want.long()] - score[rows, got.long()]).abs()
    err = float(gap.max())
    for b in torch.nonzero(got != want).flatten().tolist():
        top2 = torch.topk(score[b], 2).values
        print(f"  sample row {b}: kernel {int(got[b])} plain {int(want[b])}"
              f" score gap {float(gap[b]):.3g}, top-2 gap "
              f"{float(top2[0] - top2[1]):.3g}")
        check(float(gap[b]) <= SAMPLE_TIE_REL * float(score[b].abs().max()),
              f"sample row {b} differs beyond a last-ulp tie")
    print(f"fused_sample B={B} V={V}: greedy rows bitwise == torch.argmax, "
          f"temperature rows {int((got == want).sum())}/{B} equal to plain")
    ms = median_ms(lambda: ops.fused_sample(logits, temps, key), flush=flush)
    plain_ms = median_ms(lambda: sm.fused_sample_plain(logits, temps, key),
                         flush=flush)
    library_ms = median_ms(lambda: torch.argmax(logits, dim=-1),
                           flush=flush)
    hot = int((temps > 0).sum())
    nbytes = B * V * 4 + B * 4 + 16 + B * 4
    ops_count = B * V + hot * V * 18     # compare; div, add, 2 logs, hash
    t_b, t_f = nbytes / HBM_BYTES_PER_S, ops_count / F32_FLOPS_PER_S
    bound_ms, bound_by = max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f
                                               else "operations")
    print(f"fused_sample: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.argmax {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({bound_by})")
    return {"name": "fused_sample", "route": "cuda",
            "source": "src/repro_torch/csrc/sampling.cu",
            "replaces": "src/repro/kernels/sampling.py:51",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# ---------------------------------------------------------------- phase 3


def _bound(nbytes: float, int_ops: float):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, int_ops / INT32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_cache_sim(flush, T: int = 65536) -> float:
    """Both LRU kernels against their plain versions on the card, over
    traces of ``T`` accesses, at shapes beside slice C's: odd and ragged
    set counts, one set, 1, 4 and 16 ways.  Returns the time of one link
    of the longest dependent chain, in ns."""
    from repro_torch.core.cachesim import _ladder_sets, synthetic_traces
    from repro_torch.core.constants import GPU_L2_MB, LINE_BYTES, MB
    from repro_torch.core.sweep import capacity_ladder
    from repro_torch.kernels import cache_sim as cs
    from repro_torch.kernels import ops
    scale, ways = 16, 16
    ladder_mb = capacity_ladder(steps_per_octave=1, include=(GPU_L2_MB,))
    ladder = _ladder_sets(ladder_mb, scale=scale, ways=ways)
    host = synthetic_traces(T, int(256 * MB) // (LINE_BYTES * scale),
                            seeds=(0, 1))
    traces = torch.from_numpy(host.astype(np.int32)).to(DEVICE)
    got = ops.cache_sim_ladder(traces, num_sets=ladder, ways=ways)
    want = cs.cache_sim_ladder_plain(traces, ladder, ways=ways)
    torch.cuda.synchronize()
    bad = int((got != want).sum())
    check(bad == 0, f"cache_sim_ladder: {bad} counts differ from plain")
    check(bool((got.sum(2) == T).all()), "ladder hits + misses != T")
    print(f"cache_sim_ladder W={got.shape[0]} T={T} rungs {ladder} (ways "
          f"{ways}, 1:{scale}): 0 of {got.numel()} counts differ from plain")

    line = torch.from_numpy(host[0].astype(np.int64)).to(DEVICE)
    for ns, w in ((1, 1), (1, 16), (81, 4), (362, 1), (1536, 16),
                  (11585, 16), (97, 4)):
        sid, tag = (line % ns).int(), (line // ns).int()
        got = ops.cache_sim(sid, tag, num_sets=ns, ways=w)
        want = cs.cache_sim_plain(sid, tag, num_sets=ns, ways=w)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"cache_sim ns={ns} ways={w}: kernel "
              f"{got.tolist()} != plain {want.tolist()}")
        check(int(got.sum()) == T, "cache_sim hits + misses != T")
        print(f"cache_sim ns={ns} ways={w} tile="
              f"{cs.largest_divisor_tile(ns)}: [hits, misses] "
              f"{got.tolist()} == plain")
    # every access to set 0 of a 256-set tile: one thread applies all T
    # updates in order while the block's 256 threads stage the trace, as
    # the hottest set's thread does in the full-scale runs; the time per
    # access is one link of the critical path
    hot = (tag * 256).view(1, -1)
    chain_ms = median_ms(lambda: ops.cache_sim_ladder(hot, num_sets=(256,),
                                                      ways=16), runs=5,
                         flush=flush)
    print(f"cache_sim_ladder, all {T} accesses on one set of a 256-set "
          f"tile, 16 ways: {chain_ms:.4f} ms = {chain_ms * 1e6 / T:.2f} ns "
          f"per dependent update")
    return chain_ms * 1e6 / T


# ---------------------------------------------------------------- phase 4


def phase_slice_a() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import (DONE, Engine, Request, latency_summary,
                                   mixed_requests, run_staggered,
                                   staggered_groups)
    cfg = get_config("llama3-8b")
    model = build_model(cfg, max_seq=1024)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    t = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in params.values())
    eng = Engine(model, params, slots=8, max_len=1024, ticks_per_sync=8)
    kvbytes = sum(c.numel() * c.element_size() for c in eng.cache.values())
    print(f"slice A: llama3-8b {cfg.num_layers} layers d_model "
          f"{cfg.d_model} {cfg.dtype}: weights {wbytes / 1e9:.2f} GB "
          f"(made in {time.perf_counter() - t:.1f} s), KV "
          f"{kvbytes / 1e9:.2f} GB at 8 slots x 1024")
    warm = Request(uid=-1, prompt=list(range(1, 40)), max_new_tokens=9)
    eng.submit(warm)
    eng._admit()
    # a decode window must not wait on the card: any host sync inside it
    # raises under the "error" sync-debug mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._window()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("slice A: no host sync inside a decode window")
    eng.reset()
    reqs = mixed_requests(16, seed=0, vocab=cfg.vocab_size,
                          prompt_lens=(16, 300), max_new=(16, 64))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    outputs = run_staggered(eng, staggered_groups(reqs, 8))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.launches)
    check(all(r.state == DONE for r in reqs), "a request did not end DONE")
    check(eng.counts["nonfinite_rows"] == 0, "non-finite logits")
    check(all(0 <= tok < cfg.vocab_size for o in outputs.values()
              for tok in o), "token out of the vocabulary")
    ticks, calls = eng.counts["decode_ticks"], eng.counts["prefill_calls"]
    print(f"slice A: launches {launches}, decode ticks {ticks}, prefill "
          f"calls {calls}")
    check(launches["decode_attention"] == cfg.num_layers * ticks,
          "decode_attention launches != layers x ticks")
    check(launches["fused_sample"] == ticks + calls,
          "fused_sample launches != ticks + prefill calls")
    ntok = sum(len(o) for o in outputs.values())
    lat = latency_summary(reqs)
    ttft, itl = lat["wall"]["ttft_s"], lat["wall"]["tpot_s"]
    print(f"slice A: 16/16 DONE, {ntok} tokens in {wall:.3f} s = "
          f"{ntok / wall:.1f} tok/s; TTFT p50 {ttft['p50'] * 1e3:.1f} ms "
          f"p99 {ttft['p99'] * 1e3:.1f} ms; ITL p50 "
          f"{itl['p50'] * 1e3:.2f} ms p99 {itl['p99'] * 1e3:.2f} ms; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    trace_window(eng, cfg.vocab_size)
    return launches


def trace_window(eng, vocab: int) -> None:
    """Profile one decode window with 8 busy slots (prompts 150-300): its
    wall time, the device time of its kernels, the device's busy share and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import mixed_requests
    eng.reset()
    for r in mixed_requests(8, seed=3, vocab=vocab, prompt_lens=(150, 300),
                            max_new=(64, 64)):
        eng.submit(r)
    eng._admit()
    eng._window().cpu()                       # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._window().cpu()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._window().cpu()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: e.self_device_time_total   # noqa: E731
    busy = sum(dev_us(e) for e in kern) / 1e3
    k = eng.ticks_per_sync
    print(f"trace: decode window of {k} ticks, 8 slots: {wall * 1e3:.2f} "
          f"ms wall untraced, {busy:.2f} ms of kernels traced, device busy "
          f"{busy / (wall * 1e3):.3f} of the untraced wall; "
          f"{sum(e.count for e in kern) / k:.0f} kernel launches per tick")
    for e in sorted(kern, key=dev_us, reverse=True)[:8]:
        print(f"  {dev_us(e) / 1e3 / k:8.3f} ms/tick  {e.count // k:5d}/tick"
              f"  {e.key[:80]}")


# ---------------------------------------------------------------- phase 5


def phase_slice_b() -> None:
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import (Engine, EngineReference, mixed_requests,
                                   run_staggered, staggered_groups)
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=4,
                              dtype="float32")
    model = build_model(cfg, max_seq=512)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = model.init(gen)

    def reqs():
        return mixed_requests(8, seed=1, vocab=cfg.vocab_size,
                              prompt_lens=(16, 128), max_new=(8, 32))

    ops.reset_launches()
    eng = Engine(model, params, slots=8, max_len=512, ticks_per_sync=8)
    out_k = run_staggered(eng, staggered_groups(reqs(), 4))
    launches = dict(ops.launches)
    ref = EngineReference(model, params, slots=8, max_len=512)
    out_r = run_staggered(ref, staggered_groups(reqs(), 4))
    check(launches["decode_attention"] > 0 and launches["fused_sample"] > 0,
          "slice B kernel engine did not launch the kernels")
    for uid in out_r:
        check(out_k[uid] == out_r[uid],
              f"slice B request {uid}: kernel {out_k[uid]} != reference "
              f"{out_r[uid]}")
    ntok = sum(len(o) for o in out_r.values())
    print(f"slice B: llama3-8b width, 4 layers, f32: kernel Engine == "
          f"EngineReference on 8 requests, {ntok} greedy tokens; launches "
          f"{launches}")


# ---------------------------------------------------------------- phase 6


def lru_oracle(trace, num_sets: int, ways: int):
    """(hits, misses) of a plain OrderedDict LRU, one dict per set."""
    sets = [collections.OrderedDict() for _ in range(num_sets)]
    hits = 0
    for line in trace.tolist():
        s = sets[line % num_sets]
        tag = line // num_sets
        if tag in s:
            hits += 1
            s.move_to_end(tag)
        else:
            if len(s) >= ways:
                s.popitem(last=False)
            s[tag] = True
    return hits, len(trace) - hits


def timed_once(fn):
    """``fn()`` once between two CUDA events: (its result, ms)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def phase_slice_c(ns_per_update: float, W: int = 4, T: int = 2 ** 22,
                  scale: int = 1):
    """The simulator at full scale: 16 rungs at 1:``scale``, ``W`` traces
    of ``T`` accesses.  Every (trace, rung) count is held against the
    plain ladder (independent of the update the two kernels share), the
    64 per-point runs and, at 3 MB on trace 0, the per-point plain version
    and an OrderedDict LRU.  Returns the launches of the main path and the
    kernels' rows for the JSON line, timed at these shapes."""
    from repro_torch.core.cachesim import (ANALYTIC_TOL_PCT, _ladder_sets,
                                           capacity_lines,
                                           dram_reduction_curve,
                                           simulate_ladder,
                                           simulate_reference,
                                           synthetic_traces)
    from repro_torch.core.constants import GPU_L2_MB, LINE_BYTES, MB
    from repro_torch.core.dram import dram_reduction_pct, dram_scale
    from repro_torch.core.iso import iso_area, iso_area_capacities
    from repro_torch.core.sweep import capacity_ladder
    from repro_torch.kernels import cache_sim as cs
    from repro_torch.kernels import ops
    ways = 16
    footprint = int(256 * MB) // (LINE_BYTES * scale)
    ladder_mb = capacity_ladder(include=(GPU_L2_MB,))
    L = len(ladder_mb)
    check(L == 16, f"ladder has {L} rungs")
    t0 = time.perf_counter()
    traces = synthetic_traces(T, footprint, seeds=range(W))
    print(f"slice C: {W} zipf traces x {T} accesses over {footprint} lines "
          f"made in {time.perf_counter() - t0:.2f} s; rungs (MB) "
          f"{[round(c, 3) for c in ladder_mb]}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    counts = simulate_ladder(traces, ladder_mb, scale=scale, ways=ways,
                             device=DEVICE)
    ladder_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    per_point = np.array([[simulate_reference(
        tr, capacity_lines(c, scale=scale), ways=ways, device=DEVICE)
        for c in ladder_mb] for tr in traces], dtype=np.int64)
    point_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    check(launches["cache_sim_ladder"] == 1
          and launches["cache_sim"] == W * L,
          f"slice C launches {launches}: want 1 ladder and {W * L} "
          f"per-point")
    check(np.array_equal(counts, per_point),
          f"ladder != per point at {np.argwhere(counts != per_point)[:4]}")
    check(bool((counts.sum(2) == T).all()), "hits + misses != T")
    print(f"slice C: simulate_ladder {ladder_s:.3f} s wall, {W * L} x "
          f"simulate_reference {point_s:.3f} s wall, peak memory "
          f"{peak / 1e9:.3f} GB; ladder == {W * L} per-point runs bit for "
          f"bit; launches {launches}")

    lines = torch.from_numpy(traces.astype(np.int32)).to(DEVICE)
    ladder = _ladder_sets(ladder_mb, scale=scale, ways=ways)
    torch.cuda.reset_peak_memory_stats()
    plain, plain_ms = timed_once(
        lambda: cs.cache_sim_ladder_plain(lines, ladder, ways=ways))
    plain_peak = torch.cuda.max_memory_allocated()
    plain = plain.cpu().numpy()
    check(np.array_equal(counts, plain),
          f"ladder != plain at {np.argwhere(counts != plain)[:4]}")
    ms = median_ms(lambda: ops.cache_sim_ladder(lines, num_sets=ladder,
                                                ways=ways), runs=3, warm=1)
    bound_ms, bound_by = _bound(W * T * 4 + W * L * 2 * 8,
                                W * T * L * (1 + ways))
    print(f"slice C: all {W * L} (trace, rung) counts == plain ladder "
          f"bit for bit; cache_sim_ladder kernel {ms:.3f} ms (median of 3), "
          f"plain {plain_ms:.1f} ms (once, peak memory "
          f"{plain_peak / 1e9:.3f} GB), bound {bound_ms:.5f} ms "
          f"({bound_by}); no library call")
    ladder_row = {"name": "cache_sim_ladder", "route": "cuda",
                  "source": "src/repro_torch/csrc/cache_sim.cu",
                  "replaces": "src/repro/kernels/cache_sim.py:110",
                  "max_abs_err": float(np.abs(counts - plain).max()),
                  "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                  "bound_by": bound_by, "library_ms": None}
    del plain
    torch.cuda.empty_cache()

    i3 = ladder_mb.index(GPU_L2_MB)
    ns3 = ladder[i3]
    sid, tag = lines[0] % ns3, lines[0] // ns3
    got = ops.cache_sim(sid, tag, num_sets=ns3, ways=ways)
    want, plain_ms = timed_once(
        lambda: cs.cache_sim_plain(sid, tag, num_sets=ns3, ways=ways))
    check(torch.equal(got, want), f"cache_sim at 3 MB, trace 0: kernel "
          f"{got.tolist()} != plain {want.tolist()}")
    t0 = time.perf_counter()
    oracle = lru_oracle(traces[0], ns3, ways)
    oracle_s = time.perf_counter() - t0
    check(tuple(counts[0, i3]) == oracle,
          f"3 MB rung {tuple(counts[0, i3])} != OrderedDict LRU {oracle}")
    ms = median_ms(lambda: ops.cache_sim(sid, tag, num_sets=ns3, ways=ways),
                   runs=3, warm=1)
    pbound_ms, pbound_by = _bound(2 * T * 4 + 2 * 8, T * (1 + ways))
    print(f"slice C: 3 MB rung of trace 0 ({ns3} sets): cache_sim == "
          f"cache_sim_plain == OrderedDict LRU {oracle} ({oracle_s:.1f} s); "
          f"kernel {ms:.3f} ms (median of 3), plain {plain_ms:.1f} ms "
          f"(once), bound {pbound_ms:.5f} ms ({pbound_by}); no library call")
    point_row = {"name": "cache_sim", "route": "cuda",
                 "source": "src/repro_torch/csrc/cache_sim.cu",
                 "replaces": "src/repro/kernels/cache_sim.py:38",
                 "max_abs_err": float((got - want).abs().max()),
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": pbound_ms,
                 "bound_by": pbound_by, "library_ms": None}

    ratio = counts[:, :, 1] / T
    print("slice C: miss ratio per rung, trace 0: " + ", ".join(
        f"{c:g}MB {r:.4f}" for c, r in zip(ladder_mb, ratio[0])))
    # the longest per-set chain: the critical path of both kernels
    chain, where = 0, None
    for w, tr in enumerate(traces):
        for c, ns in zip(ladder_mb, ladder):
            n = int(np.bincount(tr % ns).max())
            if n > chain:
                chain, where = n, (w, c)
    print(f"slice C: longest per-set chain {chain} accesses ({chain / T:.3f}"
          f" of a trace; trace {where[0]}, {where[1]:g} MB) x "
          f"{ns_per_update:.2f} ns per dependent update = "
          f"{chain * ns_per_update / 1e6:.2f} ms critical path")

    ops.reset_launches()
    t0 = time.perf_counter()
    caps = iso_area_capacities(device=DEVICE)
    res = iso_area(dram_model="trace", device=DEVICE,
                   trace_kwargs={"scale": scale, "trace_len": T})
    ana = iso_area(device=DEVICE)
    curve = dram_reduction_curve(scale=scale, trace_len=T, device=DEVICE)
    print(f"slice C: iso-area capacities {caps}; trace vs analytic DRAM "
          f"model, launches {dict(ops.launches)}, "
          f"{time.perf_counter() - t0:.2f} s")
    for r, a in zip(res[:2], ana[:2]):
        for m in ("STT", "SOT"):
            print(f"  {r.workload} {m}: EDP+DRAM x{r.metrics[m]['edp_with_dram']:.4f}"
                  f" (trace) vs x{a.metrics[m]['edp_with_dram']:.4f} (analytic,"
                  f" DRAM scale {dram_scale(caps[m]):.4f})")
    for c, pct in curve.items():
        print(f"  DRAM reduction vs 3 MB at {c:g} MB: {pct:.2f}% (trace, "
              f"1:{scale}) vs {dram_reduction_pct(c):.2f}% (analytic); band "
              f"+/-{ANALYTIC_TOL_PCT} points is the CPU tests' at 1:32, "
              f"not gated here")
    return launches, [ladder_row, point_row]


# ---------------------------------------------------------------- phase 7


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_pipeline() -> None:
    """The quickstart, tune_all and paper_profiles on the card and on the
    CPU: selections identical, PPA and traffic fields within rel 1e-6."""
    from repro_torch.core.cache_model import PPA_METRICS
    from repro_torch.core.profiles import paper_profiles
    from repro_torch.core.tuner import tune_all
    from repro_torch.examples import quickstart
    t0 = time.perf_counter()
    res = {d: quickstart.run(d) for d in (DEVICE, "cpu")}
    tuned = {d: tune_all(device=d) for d in (DEVICE, "cpu")}
    profs = {d: paper_profiles(device=d) for d in (DEVICE, "cpu")}
    print(f"pipeline: quickstart, tune_all, paper_profiles on {DEVICE} and "
          f"cpu in {time.perf_counter() - t0:.2f} s")
    print("\n".join(quickstart.report(res[DEVICE])))
    pairs = [(res[DEVICE]["cfgs"][m], res["cpu"]["cfgs"][m])
             for m in res["cpu"]["cfgs"]]
    pairs += [(tuned[DEVICE][m][c], tuned["cpu"][m][c])
              for m in tuned["cpu"] for c in tuned["cpu"][m]]
    worst = 0.0
    for g, c in pairs:
        check((g.banks, g.rows, g.access_type) ==
              (c.banks, c.rows, c.access_type),
              f"selection differs at {c.mem} {c.capacity_mb} MB")
        worst = max([worst] + [_rel(getattr(g, f), getattr(c, f))
                               for f in PPA_METRICS])
    tworst = 0.0
    for g, c in zip(profs[DEVICE] + [res[DEVICE]["profile"]],
                    profs["cpu"] + [res["cpu"]["profile"]]):
        tworst = max([tworst] + [_rel(getattr(g, f), getattr(c, f))
                                 for f in ("l2_reads", "l2_writes", "dram")])
    vworst = max(_rel(res[DEVICE]["verdict"][m][k],
                      res["cpu"]["verdict"][m][k])
                 for m in res["cpu"]["verdict"]
                 for k in res["cpu"]["verdict"][m])
    print(f"pipeline: {len(pairs)} Algorithm-1 selections identical on "
          f"{DEVICE} and cpu; max rel difference PPA {worst:.3g}, traffic "
          f"{tworst:.3g}, verdict {vworst:.3g} (bound 1e-6)")
    check(worst <= 1e-6 and tworst <= 1e-6,
          "PPA or traffic fields differ beyond rel 1e-6")
    caps = res[DEVICE]["iso_area"]
    check(caps == res["cpu"]["iso_area"], f"iso-area {caps} != cpu "
          f"{res['cpu']['iso_area']}")
    check(6.0 <= caps["STT"] <= 9.5 and 8.5 <= caps["SOT"] <= 13.0,
          f"iso-area capacities {caps} outside STT 6-9.5, SOT 8.5-13 MB")
    print(f"pipeline: iso-area capacities {caps} on both (bands STT "
          f"6-9.5 MB, SOT 8.5-13 MB; paper 7 and 10)")


def main() -> None:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: the smoke needs a "
              "CUDA card", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_card()
    phase_build()
    scratch = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=DEVICE)
    flush = scratch.zero_     # 256 MB write evicts the 50 MB L2
    kernels = [phase_decode_attention(flush), phase_sampling(flush)]
    ns_per_update = phase_cache_sim(flush)
    del scratch
    launches = phase_slice_a()
    torch.cuda.empty_cache()
    phase_slice_b()
    torch.cuda.empty_cache()
    launches_c, rows = phase_slice_c(ns_per_update)
    kernels += rows
    phase_pipeline()
    for k in kernels:
        k["launches"] = (launches_c if k["name"].startswith("cache_sim")
                         else launches)[k["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{n: k[n] for n in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
