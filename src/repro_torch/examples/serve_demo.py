"""Batched serving demo: continuous batching over a reduced LM, the
counterpart of ``examples/serve_demo.py``.  Runs on the CUDA device unless
told otherwise:

    PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--ticks-per-sync", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = reduced(get_config(args.arch))
    model = build_model(cfg, max_seq=args.max_len, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    eng = Engine(model, params, slots=args.slots, max_len=args.max_len,
                 ticks_per_sync=args.ticks_per_sync, record_traffic=False,
                 device=args.device)

    prompts = [[1, 2, 3], [7, 8], [11, 12, 13, 14], [21], [31, 32], [41]]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=8,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    windows = 0
    while eng._queue or any(s is not None for s in eng.slot_req):
        n = eng.step()
        windows += 1
        print(f"window {windows} (tick {eng.ticks:3d}): "
              f"{n} active sequences")
    for r in reqs:
        print(f"req {r.uid}: prompt={r.prompt} -> output={r.output} "
              f"(done at tick {r.done_tick})")
    print(f"served {len(prompts)} requests on {args.slots} slots in "
          f"{eng.ticks} ticks / {windows} host syncs (continuous batching)")


if __name__ == "__main__":
    main()
