"""Single-device serving launcher for the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --no-reduced --slots 8 --max-len 1024 --ticks-per-sync 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --paged \
        --shared-prefix --no-reduced --slots 8 --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --no-reduced --slots 8 --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-2b --no-reduced --slots 8 --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --no-reduced --slots 8 --max-len 1024
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --paged --shared-prefix
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
        --no-reduced --slots 8 --max-len 1536
    PYTHONPATH=src python -m repro_torch.launch.serve --arrival-rate 0.5 \
        --burst-amp 0.6 --deadline-ticks 64 --max-queue-depth 4 \
        --trace-out /tmp/serve.json
    PYTHONPATH=src python -m repro_torch.launch.serve --list-configs

Runs on the CUDA device unless ``--device cpu`` is given; weights are
random, drawn from a ``torch.Generator`` seeded by ``--seed``.  Serves
``--requests`` mixed requests in staggered groups of ``--slots`` and
prints tokens/s and TTFT/TPOT percentiles.  ``--arrival-rate > 0``
serves generated traffic instead: Poisson arrivals in the tick domain
(burst-modulated by ``--burst-amp`` / ``--burst-period``), lognormal
prompt and output lengths, each request submitted at its arrival tick;
the run fails if its latency percentiles are empty or, without admission
control, a request was not served.  ``--deadline-ticks`` gives each such
request a deadline that many ticks past its arrival and
``--max-queue-depth`` caps the admission queue (a submit beyond it is
shed).  Every run prints its terminal-state histogram and the engine's
non-zero resilience counters; ``--strict`` (the default) exits non-zero
if a request ended FAILED or not at all (SHED and TIMED_OUT are
admission control's outcomes, reported, not fatal).  ``--trace-out PATH``
writes a chrome://tracing JSON of the engine's prefill calls, decode
windows and host drains.  ``--list-configs`` prints every config with its
family and the engines that serve it, then exits.  ``--paged`` serves through ``PagedEngine`` (a shared
page pool with radix-tree prefix sharing) and prints its page and prefix
counters; ``--shared-prefix`` (paged only) serves the shared-prefix
template workload and fails if no prompt token was served from the tree.
The moe (granite, moonshot) and vlm (internvl2, on tokens alone) families
serve through both engines, as the dense one does.  The ssm (mamba2),
hybrid (recurrentgemma) and encdec (whisper-tiny: each request's prompt
is also its stub audio frames) families serve through ``Engine`` only:
``--paged`` raises ``UnsupportedFamilyError`` for them before any weight
is made.  The model's ``max_seq`` is ``--max-len``.  The mesh is the
one the elastic ladder picks for one device, as in the JAX launcher (1x1,
printed as ``devices=1 mesh={...}``), with the serving rules
``default_rules(fsdp=False)``, which shard no weight on one device; as
nothing on the serve path reads a mesh, no process group is opened and
the serve tick runs no ``activation_sharding``.  ``--verdicts`` (the
default) counts the
engine's traffic and prints its serve-mode NVM verdicts, the SRAM/STT/SOT
tier energy and EDP ratios of each serve phase (times modeled at the TPU
tier's constants, not measured); ``--no-verdicts`` counts nothing.
"""
import argparse
import collections
import time

import torch

from repro_torch.configs import all_configs, get_config, reduced as reduce_cfg
from repro_torch.launch.mesh import ladder_mesh_sizes, require_unsharded
from repro_torch.models import build_model
from repro_torch.models.api import serve_families
from repro_torch.sharding import default_rules, tree_specs
from repro_torch.serve import (FAILED, Engine, PagedEngine, ShedPolicy,
                               Tracer, UnsupportedFamilyError,
                               latency_summary, mixed_requests,
                               poisson_requests, run_arrivals, run_staggered,
                               shared_prefix_requests, staggered_groups)


def _print_latency(summary: dict) -> None:
    print(f"latency over {summary['completed']}/{summary['n']} requests "
          f"({summary['tokens']} tokens):")
    for domain, unit, scale in (("ticks", "t", 1.0), ("wall", "ms", 1e3)):
        for metric, stats in sorted(summary[domain].items()):
            line = " ".join(f"{k} {v * scale:.2f}{unit}"
                            for k, v in stats.items() if k != "max")
            print(f"  {domain:5s} {metric:7s} {line}")


def _terminal_report(eng, reqs, strict: bool) -> None:
    """Terminal-state histogram and the strict exit: a FAILED or
    non-terminal request fails the launcher; shed and timed-out requests
    are admission control's outcomes, reported, not fatal."""
    hist = collections.Counter(r.state for r in reqs)
    rs = eng.resilience_stats()
    extras = {k: v for k, v in rs.items()
              if v and k not in ("shed", "timed_out", "failed")}
    print("terminal states: "
          + " ".join(f"{k}={v}" for k, v in sorted(hist.items()))
          + (f"  resilience: {extras}" if extras else ""))
    stuck = [r.uid for r in reqs if not r.terminal]
    failed = [r.uid for r in reqs if r.state == FAILED]
    if strict and (stuck or failed):
        raise SystemExit(
            f"strict mode: {len(stuck)} non-terminal {stuck[:8]} / "
            f"{len(failed)} FAILED {failed[:8]} requests "
            f"(states: {dict(hist)})")


def _list_configs() -> None:
    """Every config with its family and the engines that serve it
    (``Engine`` / ``EngineReference``: "dense", ``PagedEngine``:
    "paged")."""
    paged = serve_families("paged")
    print(f"{'arch':<22} {'family':<8} engines")
    for arch, cfg in all_configs().items():
        engines = ["Engine", "EngineReference"]
        if cfg.family in paged:
            engines.append("PagedEngine")
        print(f"{arch:<22} {cfg.family:<8} {', '.join(engines)}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--list-configs", action="store_true",
                    help="print every config with its family and the "
                         "serve engines that accept it, then exit")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="smoke-sized config (--no-reduced for full size)")
    ap.add_argument("--ticks-per-sync", type=int, default=8,
                    help="decode ticks per host drain (K)")
    ap.add_argument("--attn-impl", choices=("plain", "kernel"),
                    default="kernel",
                    help="decode-tick attention: the CUDA kernel or its "
                         "plain PyTorch version")
    ap.add_argument("--sample-impl", choices=("plain", "kernel"),
                    default="kernel",
                    help="token sampling: the CUDA kernel or its plain "
                         "PyTorch version")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for every 2nd request "
                         "(0 = all greedy)")
    ap.add_argument("--paged", action="store_true",
                    help="serve through PagedEngine: KV in a shared page "
                         "pool with radix-tree prefix sharing")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (--paged only)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical page-pool size (--paged only; default "
                         "slots * max_len / page_size)")
    ap.add_argument("--shared-prefix", action="store_true",
                    help="serve the shared-prefix template workload and "
                         "fail unless prefix pages are shared (--paged "
                         "only)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="mean Poisson arrivals per decode tick; > 0 "
                         "switches to arrival-driven traffic with "
                         "heavy-tailed lengths")
    ap.add_argument("--burst-amp", type=float, default=0.0,
                    help="sinusoidal burst modulation amplitude in [0, 1] "
                         "of the arrival rate")
    ap.add_argument("--burst-period", type=float, default=64.0,
                    help="burst modulation period in ticks")
    ap.add_argument("--deadline-ticks", type=float, default=None,
                    help="per-request deadline in ticks past arrival "
                         "(arrival-driven runs only); overdue work is "
                         "shed or timed out instead of served late")
    ap.add_argument("--max-queue-depth", type=int, default=None,
                    help="admission queue cap: submissions beyond it are "
                         "shed")
    ap.add_argument("--strict", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="exit non-zero if any request ends FAILED or "
                         "non-terminal (--no-strict to just report)")
    ap.add_argument("--trace-out", default=None,
                    help="write a chrome://tracing JSON of the engine's "
                         "prefill calls, decode windows and host drains "
                         "to this path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verdicts", action=argparse.BooleanOptionalAction,
                    default=True, help="print serve-mode NVM verdicts")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.list_configs:
        _list_configs()
        return
    if args.shared_prefix and not args.paged:
        ap.error("--shared-prefix requires --paged")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, max_seq=args.max_len, device=args.device)
    if args.paged and "paged" not in model.serve_modes:
        raise UnsupportedFamilyError(cfg.family, serve_families("paged"),
                                     "PagedEngine",
                                     detail="pages hold positioned KV rows "
                                            "of a decoder")
    # serving: params over the model axis only
    require_unsharded(tree_specs(model.param_axes(), model.abstract_params(),
                                 ladder_mesh_sizes(1),
                                 default_rules(fsdp=False)), "weights")
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    tracer = Tracer(name=f"serve-{args.arch}") if args.trace_out else None
    kw = dict(slots=args.slots, max_len=args.max_len, seed=args.seed,
              ticks_per_sync=args.ticks_per_sync, attn_impl=args.attn_impl,
              sample_impl=args.sample_impl, record_traffic=args.verdicts,
              device=args.device, tracer=tracer,
              shed_policy=ShedPolicy(max_queue_depth=args.max_queue_depth))
    if args.paged:
        eng = PagedEngine(model, params, page_size=args.page_size,
                          num_pages=args.num_pages, **kw)
    else:
        eng = Engine(model, params, **kw)
    temp_every = 2 if args.temperature > 0 else 0
    if args.shared_prefix:
        # template length off the page grid, so that every reuse copies a
        # boundary page (the JAX launcher's rule)
        ps = args.page_size
        tlen = max(ps + ps // 2, args.max_len // 2 - ps // 2)
        reqs = shared_prefix_requests(
            args.requests, seed=args.seed, vocab=cfg.vocab_size,
            template_len=min(tlen, args.max_len - 10), suffix_lens=(2, 8),
            max_new=(2, max(2, args.max_len // 8)),
            temperature=args.temperature, temperature_every=temp_every)
    elif args.arrival_rate > 0:
        reqs = poisson_requests(
            args.requests, seed=args.seed, vocab=cfg.vocab_size,
            arrival_rate=args.arrival_rate, burst_amp=args.burst_amp,
            burst_period=args.burst_period,
            prompt_bounds=(2, max(2, args.max_len // 4)),
            new_bounds=(1, max(2, args.max_len // 8)),
            temperature=args.temperature, temperature_every=temp_every,
            deadline_ticks=args.deadline_ticks)
    else:
        reqs = mixed_requests(
            args.requests, seed=args.seed, vocab=cfg.vocab_size,
            prompt_lens=(2, max(2, args.max_len // 4)),
            max_new=(2, max(2, args.max_len // 8)),
            temperature=args.temperature, temperature_every=temp_every)
    arrivals = args.arrival_rate > 0 and not args.shared_prefix
    t0 = time.perf_counter()
    if arrivals:
        outputs = run_arrivals(eng, reqs, strict=args.strict)
    else:
        outputs = run_staggered(eng, staggered_groups(reqs, args.slots))
    if model.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ntok = sum(len(o) for o in outputs.values())
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")
    print(f"served {args.requests} requests / {ntok} tokens in {eng.ticks} "
          f"ticks (K={args.ticks_per_sync}, attn={args.attn_impl}, "
          f"sample={args.sample_impl}{', paged' if args.paged else ''}) = "
          f"{ntok / dt:.1f} tok/s on {where}")
    summary = latency_summary(reqs)
    _print_latency(summary)
    if args.paged:
        st = eng.paged_stats()
        print(f"paged KV: pages-in-use high-water {st['pages_hwm']}"
              f"/{eng.num_pages} (page_size={eng.page_size}), "
              f"prefix-hit rate {st['prefix_hit_rate']:.2f} "
              f"({st['prefix_tokens']}/{st['prompt_tokens']} prompt "
              f"tokens), CoW copies {st['cow_copies']}, "
              f"radix nodes {st['radix_nodes']}, "
              f"deferred {st['deferred']}, evicted {st['evicted_pages']}")
        if args.shared_prefix and st["prefix_tokens"] == 0:
            raise SystemExit("shared-prefix workload produced zero prefix "
                             "hits: radix-tree sharing is broken")
    _terminal_report(eng, reqs, args.strict)
    if arrivals:
        # with admission control on (deadlines or a queue cap), shed and
        # timed-out outcomes are legitimate; without it, anything short
        # of full completion is a fault
        shedding = (args.deadline_ticks is not None
                    or args.max_queue_depth is not None)
        complete = (summary["completed"] == args.requests
                    or (shedding and summary["completed"] > 0))
        if not complete or not summary["wall"] or not summary["ticks"]:
            raise SystemExit(
                f"latency percentiles empty or incomplete: "
                f"{summary['completed']}/{args.requests} requests finished")
    if tracer is not None:
        path = tracer.save(args.trace_out)
        print(f"chrome trace ({len(tracer.to_chrome_trace()['traceEvents'])}"
              f" events) -> {path}")
    if args.verdicts:
        for v in eng.nvm_verdicts():
            print(f"  {v.shape}: energy vs SRAM "
                  f"STT {v.energy_ratio['STT']:.3f} / "
                  f"SOT {v.energy_ratio['SOT']:.3f}   EDP "
                  f"STT {v.edp_ratio['STT']:.3f} / "
                  f"SOT {v.edp_ratio['SOT']:.3f}")


if __name__ == "__main__":
    main()
