"""End-to-end training driver (torch counterpart of
``examples/train_lm.py``): train a reduced LM for a few hundred steps with
the port's full training stack: fused K-step train windows with batches
made on the device (``train/trainer.py::make_train_window``), AdamW,
checkpointing with auto-resume, the straggler monitor, and the window's
train-mode NVM verdicts at the end.  ``--no-fused`` runs the per-step
loop (host pipeline batches, one host sync per step).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --steps 40

Runs on the CUDA device unless ``--device cpu`` is given.  The reduced
config (4 layers, d_model 128, d_ff 256; for the ssm family also
ssm_head_dim 64, as ``launch/train.py``) unless ``--full``; weights drawn
from a ``torch.Generator`` seeded with 0.  Every ``--arch`` trains on the
token stream alone, as the JAX example does (whisper-tiny's decoder then
has no cross-attention).
"""
import argparse
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.trainer import (init_state, make_train_step,
                                       make_train_window,
                                       window_boundary_crossed)

DEFAULT_CKPT_DIR = (Path(__file__).resolve().parents[3] / "build"
                    / "train_lm_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True, help="fused K-step train windows")
    ap.add_argument("--steps-per-sync", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        ssm = {"ssm_head_dim": 64} if cfg.family == "ssm" else {}
        cfg = reduced(cfg, num_layers=4, d_model=128, d_ff=256, **ssm)
    model = build_model(cfg, max_seq=args.seq, device=device)
    opt = AdamW(lr=warmup_cosine(3e-3, 20, args.steps))
    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_state(model, opt, gen)
    start = 0
    if mgr.latest_step() is not None:
        state = mgr.restore(state)
        start = int(mgr.latest_step())
        print(f"resumed from checkpoint at step {start}")

    mon = StragglerMonitor(num_hosts=1)
    last_loss = None
    if args.fused:
        K = args.steps_per_sync
        win = make_train_window(model, opt, steps_per_sync=K,
                                data_cfg=dcfg)
        step, t_last = start, time.perf_counter()
        while step < args.steps:
            state, metrics = win(state)
            # one drain per window: loss and grad_norm in one transfer
            losses, gnorms = torch.stack(
                [metrics["loss"], metrics["grad_norm"]]).tolist()
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            mon.record(0, dt / K)
            step += K
            last_loss = losses[-1]
            print(f"step {step:4d}  loss {last_loss:.4f}  "
                  f"gnorm {gnorms[-1]:.3f}"
                  f"  {dt / K * 1e3:.1f}ms/step (fused K={K})")
            if window_boundary_crossed(step, K, args.ckpt_every) \
                    or step >= args.steps:
                mgr.save(step, state)
        for v in win.nvm_verdicts():
            print(f"  {v.shape}: energy vs SRAM "
                  f"STT {v.energy_ratio['STT']:.3f} / "
                  f"SOT {v.energy_ratio['SOT']:.3f}")
    else:
        step_fn = make_train_step(model, opt)
        data = Pipeline(dcfg, start_step=start)
        t_last = time.perf_counter()
        try:
            for i, batch in zip(range(start, args.steps), data):
                batch = {k: torch.from_numpy(v).to(device)
                         for k, v in batch.items()}
                state, metrics = step_fn(state, batch)
                last_loss = float(metrics["loss"])   # the step's host sync
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                mon.record(0, dt)
                if (i + 1) % 20 == 0:
                    print(f"step {i + 1:4d}  loss {last_loss:.4f}  "
                          f"gnorm {float(metrics['grad_norm']):.3f}  "
                          f"lr {float(metrics['lr']):.2e}  {dt * 1e3:.0f}ms")
                if (i + 1) % args.ckpt_every == 0:
                    mgr.save(i + 1, state)
        finally:
            data.close()
    mgr.wait()
    # a restore at/after --steps runs no steps: report that, don't crash
    tail = (f"final loss {last_loss:.4f}" if last_loss is not None
            else f"resumed at {start} >= --steps {args.steps}, nothing run")
    print(f"done; {tail}; checkpoints: {mgr.all_steps()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
