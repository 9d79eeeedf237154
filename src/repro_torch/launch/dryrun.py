"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the
production meshes with ``meta`` stand-ins (no allocation), count one
device's flops, bytes and collectives, derive the roofline terms and
write one JSON record per cell under ``build/dryrun/`` (torch counterpart
of ``repro/launch/dryrun.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

How a cell runs.  A fake process group of 256 (16x16) or 512 (2x16x16)
ranks is opened (``launch/mesh.fake_process_group``: torch's ``"fake"``
backend, this process playing rank 0, every collective a no-op) and the
production ``DeviceMesh`` built on it.  The abstract train state (or the
weights, and the decode cache) is made on ``meta``; each leaf's spec comes
from the logical-axis rules (``sharding/rules.py``) and the leaf becomes a
DTensor of its local shard's shape (``DTensor.from_local``), as the
inputs do.  The train step (forward, backward and the AdamW update),
``Model.prefill`` or ``Model.decode_step`` then runs once on those
DTensors under ``activation_sharding`` (the models' ``constrain`` calls
redistribute at the JAX models' points) and a per-shard ``OpCounter``:
DTensor desugars each op into the collectives of its redistributions and
the op on the local shards, and the counter sees those, so the counts are
one device's, as the JAX walker's are of one device's partitioned HLO
(``launch/graph_analysis.py``).  Nothing is computed: the shards are
``meta``.

An op DTensor cannot place (no sharding strategy, or a view that would
split a sharded dim unevenly) runs on its inputs replicated over the
innermost mesh dims, one more at a time until it runs, or with no
strategy at all on the replicas' local copies: the gathers are counted,
as GSPMD pays for an op it cannot partition, and the record's
``replicated`` names each such op with its count (``OpCounter._desugar``).
The kernels (flash attention, the two scans) run per device on the local
shards (``sharding/local.py``) and declare their traffic from the local
shapes, as on one card; on ``meta`` the wrappers give their outputs'
shapes (``kernels/ops.plain_on_meta``) and count nothing more.

The record has the JAX record's keys; ``trace_s`` (the seconds the traced
run took on the host that ran it) stands in for ``lower_s`` /
``compile_s``.
``memory.argument_bytes`` is one device's bytes of its local shards of
every argument, ``output_bytes`` those of the step's outputs; no compiler
plans the port's buffers, so ``temp_bytes``, ``alias_bytes`` and
``peak_bytes_est`` are null.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Iterator, Optional

import torch

from repro_torch.configs import SHAPES, cells, get_config, list_archs
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch import roofline as rf
from repro_torch.launch.graph_analysis import OpCounter, tensor_bytes
from repro_torch.launch.mesh import (fake_process_group, make_mesh,
                                     mesh_axis_sizes, mesh_context)
from repro_torch.models import transformer as tf
from repro_torch.models.api import Model, input_specs
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.sharding import (activation_sharding, default_rules,
                                  local_shape, placements, tree_specs)
from repro_torch.train.trainer import (abstract_state, make_train_step,
                                       state_axes)

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"

INPUT_AXES = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "frames": ("batch", "seq", "embed_act"),
    "vision_embeds": ("batch", "seq", "embed_act"),
    "enc_out": ("batch", "seq", "embed_act"),
}

PRODUCTION_MESHES = {False: {"data": 16, "model": 16},
                     True: {"pod": 2, "data": 16, "model": 16}}


def mesh_name(mesh_shape: Dict[str, int]) -> str:
    return "x".join(str(v) for v in mesh_shape.values())


# ---------------------------------------------------------------------------
# sharded meta stand-ins
# ---------------------------------------------------------------------------


def shard_tree(tree, axes, mesh, rules):
    """Each ``meta`` tensor of a (nested) dict as a DTensor on ``mesh`` of
    its global shape and dtype, placed by the rules' spec for its logical
    axes, its local shard a ``meta`` tensor (nothing is allocated)."""
    from torch.distributed.tensor import DTensor
    msizes = mesh_axis_sizes(mesh)

    def shard(t, spec):
        if isinstance(t, dict):
            return {k: shard(t[k], spec[k]) for k in t}
        local = torch.empty(local_shape(t.shape, spec, msizes),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())

    return shard(tree, tree_specs(axes, tree, mesh, rules))


def local_bytes(*trees) -> int:
    """One device's bytes of the local shards of every DTensor (or plain
    tensor) in ``trees``."""
    from torch.distributed.tensor import DTensor
    total = 0
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, DTensor):
            total += tensor_bytes(t.to_local())
        elif isinstance(t, torch.Tensor):
            total += tensor_bytes(t)
    return total


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def greedy_redistribution() -> Iterator[None]:
    """DTensor's greedy redistribution planner for every plan made in the
    body (the dry run's on a three-axis mesh).  Torch plans a
    redistribution between non-default shard orders, and prices each
    candidate strategy of an op, by a min-cost graph search over placement
    states, which on a three-axis mesh takes minutes a call (a reduced
    llama3 train step on 2x2x2 did not finish in 15 min; greedily, 25 s).
    A greedy plan may move more than the cheapest one, never less, and
    prices strategies higher, so more ops run replicated: the counts are
    an upper bound there (on a two-axis mesh, where the search is cheap,
    torch's own planner stays).  Private torch API, used only where it
    exists; the plan cache is cleared on exit so that no greedy plan
    outlives the body."""
    try:
        from torch.distributed.tensor import _redistribute as red
        planner = red.DTensorRedistributePlanner
        graph = planner.generate_graph_based_transform_infos
        planner.generate_greedy_transform_infos
    except (ImportError, AttributeError):
        yield
        return

    def greedy(self, src_spec, dst_spec, *args, **kwargs):
        return self.generate_greedy_transform_infos(src_spec, dst_spec)

    planner.generate_graph_based_transform_infos = greedy
    try:
        yield
    finally:
        planner.generate_graph_based_transform_infos = graph
        clear = getattr(getattr(red, "_gen_transform_infos", None),
                        "cache_clear", None)
        if clear is not None:
            clear()


@contextlib.contextmanager
def sharded_session(mesh_shape: Dict[str, int]) -> Iterator[object]:
    """A fake group of the mesh's size, the mesh on it, DTensor's implicit
    replication of plain tensors (the models' position and mask tensors),
    the kernel wrappers' plain versions on ``meta`` and, on a three-axis
    mesh, its greedy redistribution planner; the group is destroyed on
    exit."""
    from torch.distributed.tensor.experimental import implicit_replication
    chips = 1
    for v in mesh_shape.values():
        chips *= v
    planner = (greedy_redistribution() if len(mesh_shape) >= 3
               else contextlib.nullcontext())
    with fake_process_group(chips), planner, kernel_ops.plain_on_meta():
        mesh = make_mesh(tuple(mesh_shape.values()), tuple(mesh_shape))
        with implicit_replication():
            yield mesh


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             remat: str = None, attn_impl: str = "kernel",
             fsdp: bool = None, microbatches: int = 1,
             tag: str = "baseline", save: bool = True,
             verbose: bool = True, config_overrides: dict = None,
             rules_kwargs: dict = None,
             mesh_shape: Optional[Dict[str, int]] = None,
             results_dir: Optional[Path] = None) -> dict:
    """Trace one cell on the production mesh (or ``mesh_shape``, whose
    axes are the production names) and return its record; ``save``
    writes it to ``results_dir`` (default ``build/dryrun/``)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    overrides = dict(config_overrides or {})
    if remat is not None:
        overrides["remat"] = remat
    if fsdp is not None:
        overrides["fsdp"] = fsdp
    if shape.kind != "train":
        overrides["fsdp"] = False  # serving: params sharded over model only
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    msizes = dict(mesh_shape or PRODUCTION_MESHES[multi_pod])
    chips = 1
    for v in msizes.values():
        chips *= v
    rules = default_rules(fsdp=cfg.fsdp, multi_pod="pod" in msizes,
                          **(rules_kwargs or {}))
    model = Model(cfg=cfg, max_seq=shape.seq_len,
                  param_defs=tf.model_param_defs(cfg, shape.seq_len),
                  device=torch.device("meta"))
    specs = {k: torch.empty(shp, dtype=dt, device="meta")
             for k, (shp, dt) in input_specs(cfg, shape).items()}

    counter = OpCounter(per_shard=True)
    with sharded_session(msizes) as mesh, mesh_context(mesh), \
            activation_sharding(mesh, rules):
        batch = shard_tree(specs, {k: INPUT_AXES[k] for k in specs}, mesh,
                           rules)
        if shape.kind == "train":
            opt = AdamW(lr=warmup_cosine(3e-4, 100, 10000))
            state = shard_tree(abstract_state(model, opt),
                               state_axes(model, opt), mesh, rules)
            step_fn = make_train_step(model, opt, microbatches=microbatches,
                                      attn_impl=attn_impl)
            args = (state, batch)
            t0 = time.perf_counter()
            with counter:
                out = step_fn(state, batch)
        elif shape.kind == "prefill":
            params = shard_tree(model.abstract_params(), model.param_axes(),
                                mesh, rules)
            args = (params, batch)
            t0 = time.perf_counter()
            with counter, torch.no_grad():
                out = model.prefill(params, batch, attn_impl=attn_impl)
        else:  # decode
            B = shape.global_batch
            params = shard_tree(model.abstract_params(), model.param_axes(),
                                mesh, rules)
            cache = shard_tree(model.abstract_cache(B, shape.seq_len),
                               model.cache_axes(B, shape.seq_len), mesh,
                               rules)
            args = (params, cache, batch)
            t0 = time.perf_counter()
            with counter, torch.no_grad():
                out = model.decode_step(params, cache, batch,
                                        shape.seq_len - 1,
                                        attn_impl=attn_impl)
        trace_s = time.perf_counter() - t0
        mem = {"argument_bytes": local_bytes(*args),
               "output_bytes": local_bytes(out),
               # no compiler plans the port's buffers: these have no source
               "temp_bytes": None, "alias_bytes": None,
               "peak_bytes_est": None}
        del out, args

    roof = rf.analyze(counter.stats)
    mf = rf.model_flops(cfg, shape, chips)
    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name(msizes),
        "chips": int(chips),
        "tag": tag,
        "kind": shape.kind,
        "knobs": {"remat": cfg.remat, "attn_impl": attn_impl,
                  "fsdp": cfg.fsdp, "microbatches": microbatches},
        "trace_s": trace_s,
        "memory": mem,
        "roofline": roof.to_dict(),
        "model_flops_per_device": mf,
        "model_flops_ratio": (mf / roof.flops_per_device
                              if roof.flops_per_device else None),
        "roofline_fraction": roof.model_flops_util(mf),
        "replicated": dict(sorted(counter.replicated.items())),
    }
    if verbose:
        print(f"[{tag}] {arch} x {shape.name} x {record['mesh']}: "
              f"trace {trace_s:.1f}s  "
              f"compute {roof.compute_s * 1e3:.2f}ms  "
              f"memory {roof.memory_s * 1e3:.2f}ms  "
              f"collective {roof.collective_s * 1e3:.2f}ms  "
              f"dominant={roof.dominant}  "
              f"MF-ratio={record['model_flops_ratio'] and round(record['model_flops_ratio'], 3)}  "
              f"collectives={roof.collective_counts}  "
              f"args/dev={mem['argument_bytes'] / 2**30:.2f}GiB",
              flush=True)
    if save:
        out_dir = Path(results_dir) if results_dir else RESULTS_DIR
        out_dir.mkdir(parents=True, exist_ok=True)
        fname = f"{arch}__{shape.name}__{record['mesh']}__{tag}.json"
        (out_dir / fname).write_text(json.dumps(record, indent=1))
    gc.collect()
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--attn-impl", default="kernel")
    ap.add_argument("--fsdp", default=None,
                    type=lambda s: s.lower() in ("1", "true"))
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--results-dir", default=str(RESULTS_DIR))
    args = ap.parse_args(argv)

    targets = []
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    for arch in archs:
        shapes = [SHAPES[args.shape]] if args.shape else cells(arch)
        for shape in shapes:
            if shape.name in get_config(arch).skip_shapes:
                print(f"SKIP {arch} x {shape.name} (documented skip)")
                continue
            meshes = {"pod": [False], "multipod": [True],
                      "both": [False, True]}[args.mesh]
            for mp in meshes:
                targets.append((arch, shape.name, mp))

    failures = []
    t_all = time.perf_counter()
    out_dir = Path(args.results_dir)
    for arch, shape_name, mp in targets:
        name = mesh_name(PRODUCTION_MESHES[mp])
        out = out_dir / f"{arch}__{shape_name}__{name}__{args.tag}.json"
        if args.skip_existing and out.exists():
            print(f"skip existing {out.name}")
            continue
        try:
            run_cell(arch, shape_name, multi_pod=mp, remat=args.remat,
                     attn_impl=args.attn_impl, fsdp=args.fsdp,
                     microbatches=args.microbatches, tag=args.tag,
                     results_dir=out_dir)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, shape_name, name, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print(f"dry-run complete: {len(targets)} cells OK in "
          f"{time.perf_counter() - t_all:.1f}s")


if __name__ == "__main__":
    main()
