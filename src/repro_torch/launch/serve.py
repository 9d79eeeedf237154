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

Runs on the CUDA device unless ``--device cpu`` is given; weights are
random, drawn from a ``torch.Generator`` seeded by ``--seed``.  Serves
``--requests`` mixed requests in staggered groups of ``--slots``, prints
tokens/s and TTFT/TPOT percentiles, and exits non-zero unless every
request ended DONE.  ``--paged`` serves through ``PagedEngine`` (a shared
page pool with radix-tree prefix sharing) and prints its page and prefix
counters; ``--shared-prefix`` (paged only) serves the shared-prefix
template workload and fails if no prompt token was served from the tree.
The ssm (mamba2) and hybrid (recurrentgemma) families serve through
``Engine`` only: ``--paged`` raises ``UnsupportedFamilyError`` for them
before any weight is made.
"""
import argparse
import collections
import time

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models import build_model
from repro_torch.models.api import serve_families
from repro_torch.serve import (DONE, Engine, PagedEngine,
                               UnsupportedFamilyError, latency_summary,
                               mixed_requests, run_staggered,
                               shared_prefix_requests, staggered_groups)


def _print_latency(summary: dict) -> None:
    print(f"latency over {summary['completed']}/{summary['n']} requests "
          f"({summary['tokens']} tokens):")
    for domain, unit, scale in (("ticks", "t", 1.0), ("wall", "ms", 1e3)):
        for metric, stats in sorted(summary[domain].items()):
            line = " ".join(f"{k} {v * scale:.2f}{unit}"
                            for k, v in stats.items() if k != "max")
            print(f"  {domain:5s} {metric:7s} {line}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
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
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    kw = dict(slots=args.slots, max_len=args.max_len, seed=args.seed,
              ticks_per_sync=args.ticks_per_sync, attn_impl=args.attn_impl,
              sample_impl=args.sample_impl, device=args.device)
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
    else:
        reqs = mixed_requests(
            args.requests, seed=args.seed, vocab=cfg.vocab_size,
            prompt_lens=(2, max(2, args.max_len // 4)),
            max_new=(2, max(2, args.max_len // 8)),
            temperature=args.temperature, temperature_every=temp_every)
    t0 = time.perf_counter()
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
    _print_latency(latency_summary(reqs))
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
    hist = collections.Counter(r.state for r in reqs)
    print("terminal states: "
          + " ".join(f"{k}={v}" for k, v in sorted(hist.items())))
    if hist[DONE] != len(reqs):
        raise SystemExit(f"not every request ended DONE: {dict(hist)}")


if __name__ == "__main__":
    main()
