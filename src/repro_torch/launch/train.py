"""Single-device training launcher for the port.

    PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --steps 8 --steps-per-sync 4 [--strategy fsdp]

``--arch`` takes every family: dense, moe (granite, moonshot), vlm
(internvl2) and encdec (whisper-tiny), each trained on tokens alone, as
the JAX launcher trains them (whisper's decoder then has no
cross-attention), ssm (mamba2) and hybrid (recurrentgemma).  ``--reduced``
is the JAX launcher's smoke config (4 layers, d_model 128, d_ff 256,
head_dim 16; whisper's stacks 2 + 2 layers; for the ssm family also
ssm_head_dim 64, so that the inner width 256 is 4 heads x 64, where the
JAX launcher's would stop on it).  Without it the full config is built:
``--layers N`` cuts its depth (llama3-8b's 32 layers, 8 B parameters at
16 bytes of train state each, do not fit one 80 GB card; mamba2-1.3b,
recurrentgemma-2b and whisper-tiny fit at full depth).  whisper's stacks
are ``enc_layers`` and ``dec_layers``, which ``--layers`` does not set:
it raises ``ValueError`` for the encdec family before any weight is
made.
Runs on the CUDA device unless ``--device cpu`` is given (it never falls
back to the CPU).  Weights are random, drawn from a ``torch.Generator``
seeded with 0; the data are the counter-hash token stream (seed 0).  It
restores the latest checkpoint under ``--ckpt-dir`` if there is one, then
trains with AdamW (``warmup_cosine(--lr, 10, --steps)``), checkpointing
asynchronously every ``--ckpt-every`` steps and at the end, and feeds each
step time to the straggler monitor.

Two paths share one state layout:
  * fused (default): ``TrainWindow`` runs ``--steps-per-sync`` (K) steps
    on batches made on the device and syncs with the host once per
    window, where it prints, checkpoints and records the step time; the
    final step rounds UP to a multiple of K;
  * ``--no-fused``: the per-step oracle loop on host ``Pipeline`` batches.

The fused path counts its first window's traffic and prints the
window's train-mode NVM verdicts at the end (``--verdicts``, the
default): the SRAM/STT/SOT tier energy and EDP ratios, times modeled at
the TPU tier's constants, not measured; ``--no-verdicts`` counts nothing.

``--compress-grads`` runs the error-feedback int8 gradient compressor
(``optim/compress.py``) in the train step, and ``--compress-shards N``
splits each batch into N shard groups whose gradients combine through
the compressed all-reduce's arithmetic, each banking its own residual
(the JAX launcher's data-parallel schedule, on one device).  The state
is built and restored with ``effective_optimizer``, so a compressed run
resumes only from a compressed checkpoint with the same shard count.

The mesh is built as the JAX launcher builds its own: a one-rank process
group (NCCL on the card, gloo under ``--device cpu``), the mesh the elastic
ladder picks for its world size (``train/elastic.remesh``: 1x1 here),
printed as ``devices=1 mesh={'data': 1, 'model': 1} (model_parallelism=1)``,
and the state's specs from ``default_rules(strategy=--strategy)`` (``tp``,
the default, or ``fsdp``) under the mesh and its ``activation_sharding``.
On a mesh of one device every spec is empty, so the model keeps plain
tensors and the ctypes kernels, and both strategies train the same bits;
a sharded state (more devices) is the dry run's (``launch/dryrun.py``).
The group is destroyed when the run ends.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

import torch

from repro_torch.configs import get_config, reduced as reduce_cfg
from repro_torch.data import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (launcher_mesh, mesh_context,
                                     require_unsharded)
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.sharding import activation_sharding, default_rules, tree_specs
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import StragglerMonitor
from repro_torch.train.trainer import (abstract_state, effective_optimizer,
                                       init_state, make_train_step,
                                       make_train_window, state_axes,
                                       window_boundary_crossed)

DEFAULT_CKPT_DIR = (Path(__file__).resolve().parents[3] / "build"
                    / "train_ckpt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (4 layers, d_model 128, "
                         "head_dim 16)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused K-step train windows (--no-fused for the "
                         "per-step oracle loop)")
    ap.add_argument("--steps-per-sync", type=int, default=10,
                    help="fused train steps per host sync (K)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true",
                    help="error-feedback int8 gradient compression "
                         "(optim/compress.py) in the train step")
    ap.add_argument("--compress-shards", type=int, default=1,
                    help="data-parallel shard groups combined through "
                         "compressed_psum (requires --compress-grads)")
    ap.add_argument("--verdicts", action=argparse.BooleanOptionalAction,
                    default=True, help="print train-mode NVM verdicts "
                                       "(fused mode only)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--strategy", choices=("tp", "fsdp"), default="tp",
                    help="the sharding rules' strategy (sharding/rules.py)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.layers is not None and cfg.family == "encdec":
        raise ValueError(
            f"--layers sets num_layers, which the encdec family's stacks "
            f"(enc_layers {cfg.enc_layers}, dec_layers {cfg.dec_layers}) "
            f"do not read; {cfg.arch} trains at full depth")
    if args.reduced:
        ssm = {"ssm_head_dim": 64} if cfg.family == "ssm" else {}
        cfg = reduce_cfg(cfg, num_layers=4, d_model=128, d_ff=256, **ssm)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg, max_seq=args.seq, device=device)
    opt = AdamW(lr=warmup_cosine(args.lr, 10, args.steps))
    opt_eff = effective_optimizer(opt, args.compress_grads,
                                  args.compress_shards)
    with launcher_mesh(device.type) as (mesh, _):
        rules = state_rules(model, opt_eff, mesh, args.strategy)
        with mesh_context(mesh), activation_sharding(mesh, rules):
            return _train(args, device, cfg, model, opt, opt_eff)


def state_rules(model, opt_eff, mesh, strategy: str):
    """The rules of ``strategy`` for ``mesh``, after checking that they
    shard no leaf of the train state (every spec empty on one device)."""
    rules = default_rules(fsdp=model.cfg.fsdp,
                          multi_pod=len(mesh.mesh_dim_names) == 3,
                          strategy=strategy)
    specs = tree_specs(state_axes(model, opt_eff),
                       abstract_state(model, opt_eff), mesh, rules)
    require_unsharded(specs, f"train state ({strategy})")
    return rules


def _train(args, device, cfg, model, opt, opt_eff):
    dcfg = DataConfig(cfg.vocab_size, args.seq, args.batch)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = init_state(model, opt_eff, gen)
    nparams = sum(p.numel() for p in state["params"].values())
    print(f"device={device} arch={cfg.arch} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} params={nparams / 1e6:.1f}M "
          f"dtype={cfg.dtype} remat={cfg.remat}")

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if mgr.latest_step() is not None:
        state = mgr.restore(state)
        start = int(mgr.latest_step())
        print(f"restored step {start} from {args.ckpt_dir}")
    mon = StragglerMonitor(num_hosts=1)
    if not args.fused:
        _run_per_step(args, model, opt, dcfg, state, mgr, mon, start)
        return 0
    win = _run_fused(args, model, opt, dcfg, state, mgr, mon, start)
    if args.verdicts and win is not None:
        for v in win.nvm_verdicts():
            print(f"  {v.shape}: energy vs SRAM "
                  f"STT {v.energy_ratio['STT']:.3f} / "
                  f"SOT {v.energy_ratio['SOT']:.3f}   EDP "
                  f"STT {v.edp_ratio['STT']:.3f} / "
                  f"SOT {v.edp_ratio['SOT']:.3f}")
    return 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _straggler(mon: StragglerMonitor, step_time: float) -> None:
    mon.record(0, step_time)
    flagged = mon.stragglers()   # mutates strikes: call ONCE per record
    if flagged:
        print(f"straggler(s) {flagged}: would trigger evict+remesh")


def _run_fused(args, model, opt, dcfg, state, mgr, mon, start):
    """Window loop: K fused steps per host sync; checkpoint and straggler
    accounting at window boundaries.  Returns the window (for verdicts),
    None when there was nothing to do."""
    K = args.steps_per_sync
    if start >= args.steps:
        print(f"restored step {start} >= --steps {args.steps}; nothing to "
              f"do (checkpoints {mgr.all_steps()})")
        return None
    win = make_train_window(model, opt, steps_per_sync=K,
                            microbatches=args.microbatches,
                            compress_grads=args.compress_grads,
                            compress_shards=args.compress_shards,
                            data_cfg=dcfg, record_traffic=args.verdicts)
    tokens = dcfg.global_batch * dcfg.seq_len
    step, last_loss = start, None
    t0 = time.perf_counter()
    while step < args.steps:
        state, metrics = win(state)
        losses = metrics["loss"].tolist()   # the window's one host sync
        step += K
        dt = (time.perf_counter() - t0) / K
        t0 = time.perf_counter()
        _straggler(mon, dt)
        if window_boundary_crossed(step, K, args.ckpt_every) \
                or step >= args.steps:
            mgr.save(step, state, blocking=(step >= args.steps))
        last_loss = losses[-1]
        print(f"step {step:4d} loss {last_loss:.4f} (window mean "
              f"{sum(losses) / K:.4f}) {dt * 1e3:.1f} ms/step "
              f"{tokens / dt:.0f} tok/s")
    print(f"done @{step}: loss {last_loss:.4f}; checkpoints "
          f"{mgr.all_steps()}")
    return win


def _run_per_step(args, model, opt, dcfg, state, mgr, mon, start):
    """The per-step oracle loop (host pipeline, one sync per step)."""
    step_fn = make_train_step(model, opt, microbatches=args.microbatches,
                              compress_grads=args.compress_grads,
                              compress_shards=args.compress_shards)
    data = Pipeline(dcfg, start_step=start)
    metrics = {}
    t0 = time.perf_counter()
    try:
        for i, batch in zip(range(start, args.steps), data):
            batch = {k: torch.from_numpy(v).to(model.device)
                     for k, v in batch.items()}
            state, metrics = step_fn(state, batch)
            _sync(model.device)
            _straggler(mon, time.perf_counter() - t0)
            t0 = time.perf_counter()
            if (i + 1) % args.ckpt_every == 0:
                mgr.save(i + 1, state)
            if (i + 1) % 10 == 0:
                print(f"step {i + 1:4d} loss {float(metrics['loss']):.4f}")
        mgr.save(max(args.steps, start), state, blocking=True)
    finally:
        data.close()
    tail = (f"loss {float(metrics['loss']):.4f}; " if metrics else
            f"restored step {start} >= --steps {args.steps}, no steps run; ")
    print(f"done @{max(args.steps, start)}: {tail}"
          f"checkpoints {mgr.all_steps()}")


if __name__ == "__main__":
    sys.exit(main())
