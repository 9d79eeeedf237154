"""Single-device serving launcher for the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --no-reduced --slots 8 --max-len 1024 --ticks-per-sync 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

Runs on the CUDA device unless ``--device cpu`` is given; weights are
random, drawn from a ``torch.Generator`` seeded by ``--seed``.  Serves
``--requests`` mixed requests in staggered groups of ``--slots``, prints
tokens/s and TTFT/TPOT percentiles, and exits non-zero unless every
request ended DONE.
"""
import argparse
import collections
import time

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.models import build_model
from repro_torch.serve import (DONE, Engine, latency_summary, mixed_requests,
                               run_staggered, staggered_groups)


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    model = build_model(cfg, max_seq=args.max_len, device=args.device)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(args.seed)
    params = model.init(gen)
    eng = Engine(model, params, slots=args.slots, max_len=args.max_len,
                 seed=args.seed, ticks_per_sync=args.ticks_per_sync,
                 attn_impl=args.attn_impl, sample_impl=args.sample_impl,
                 device=args.device)
    reqs = mixed_requests(
        args.requests, seed=args.seed, vocab=cfg.vocab_size,
        prompt_lens=(2, max(2, args.max_len // 4)),
        max_new=(2, max(2, args.max_len // 8)),
        temperature=args.temperature,
        temperature_every=2 if args.temperature > 0 else 0)
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
          f"sample={args.sample_impl}) = {ntok / dt:.1f} tok/s on {where}")
    _print_latency(latency_summary(reqs))
    hist = collections.Counter(r.state for r in reqs)
    print("terminal states: "
          + " ".join(f"{k}={v}" for k, v in sorted(hist.items())))
    if hist[DONE] != len(reqs):
        raise SystemExit(f"not every request ended DONE: {dict(hist)}")


if __name__ == "__main__":
    main()
