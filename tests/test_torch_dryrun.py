"""The port's dry run (``repro_torch.launch.dryrun``) on ``meta``, on the
CPU: records of reduced llama3 (train, prefill, decode), granite-moe,
mamba2 and recurrentgemma (train: the scans forward and backward on the
local shards) on a fake 2x4 (data x model) mesh.  Every roofline
term is finite; ``memory.argument_bytes`` equals the bytes of the local
shards that JAX's ``spec_for`` gives the same leaves, exactly;
``model_flops_per_device`` equals JAX's ``model_flops``; the train cells
have collectives; ``torch.distributed`` is left uninitialised.  One device's
flops, bytes and collectives agree with the JAX dry run's on the same
cells (run in a subprocess on 8 host devices) within the bands of
``JAX_BANDS``; a kernel on DTensors declares its traffic from the local
shapes; the records read back through ``roofline_table`` and
``analyze_dryrun_dir``, and the CLI writes its records.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.launch import roofline as jrf  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.models.api import input_specs as jinput_specs  # noqa: E402
from repro.optim import AdamW as JAdamW, warmup_cosine as jwarmup  # noqa: E402
from repro.sharding.rules import default_rules as jdefault_rules  # noqa: E402
from repro.sharding.rules import spec_for as jspec_for  # noqa: E402
from repro.train.trainer import abstract_state as jabstract_state  # noqa: E402
from repro.train.trainer import state_axes as jstate_axes  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.crosslayer import analyze_dryrun_dir  # noqa: E402
from repro_torch.launch import dryrun as dr  # noqa: E402
from repro_torch.tools import roofline_table  # noqa: E402

MESH = {"data": 2, "model": 4}
TERMS = ("flops_per_device", "bytes_per_device", "collective_bytes",
         "compute_s", "memory_s", "collective_s")


def _overrides(arch: str, **kw) -> dict:
    """The fields ``reduced`` changes, as ``run_cell``'s overrides."""
    full = get_config(arch)
    small = reduced(full, **kw)
    return {f.name: getattr(small, f.name) for f in dataclasses.fields(full)
            if getattr(small, f.name) != getattr(full, f.name)}


def _jax_local_bytes(tree_axes, tree_shapes, rules) -> int:
    """Bytes of one device's shards of every leaf by JAX's ``spec_for``."""
    total = 0
    for name, shp in tree_shapes.items():
        axes = tree_axes[name]
        if isinstance(shp, dict):
            total += _jax_local_bytes(axes, shp, rules)
            continue
        spec = jspec_for(tuple(axes), tuple(shp.shape), MESH, rules)
        n = int(np.prod(shp.shape, dtype=np.int64))
        for entry in spec:
            for g in ((entry,) if isinstance(entry, str) else entry or ()):
                n //= MESH[g]
        total += n * np.dtype(shp.dtype).itemsize
    return total


def _expected_argument_bytes(arch, kind, S, B, fsdp) -> int:
    cfg = jreduced(jget_config(arch), fsdp=fsdp)
    jm = jbuild_model(cfg, max_seq=S)
    rules = jdefault_rules(fsdp=fsdp, multi_pod=False)
    shape = JShape(f"t_{kind}", S, B, kind)
    specs = jinput_specs(cfg, shape)
    total = _jax_local_bytes({k: dr.INPUT_AXES[k] for k in specs}, specs,
                             rules)
    if kind == "train":
        opt = JAdamW(lr=jwarmup(3e-4, 100, 10000))
        total += _jax_local_bytes(jstate_axes(jm, opt),
                                  jabstract_state(jm, opt), rules)
    else:
        total += _jax_local_bytes(jm.param_axes(), jm.abstract_params(),
                                  rules)
    if kind == "decode":
        total += _jax_local_bytes(jm.cache_axes(B, S),
                                  jm.abstract_cache(B, S), rules)
    return total


CELLS = [("llama3-8b", "train"), ("llama3-8b", "prefill"),
         ("llama3-8b", "decode"), ("granite-moe-3b-a800m", "train"),
         ("mamba2-1.3b", "train"), ("recurrentgemma-2b", "train")]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    recs = {}
    for arch, kind in CELLS:
        assert not dist.is_initialized()
        shape = ShapeConfig(f"t_{kind}", 64, 8, kind)
        recs[(arch, kind)] = dr.run_cell(
            arch, shape, multi_pod=False, mesh_shape=MESH, tag="t",
            config_overrides=_overrides(arch, fsdp=True),
            results_dir=out_dir, verbose=False)
        assert not dist.is_initialized()
    return out_dir, recs


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_record_terms_bytes_and_model_flops(records, cell):
    arch, kind = cell
    rec = records[1][cell]
    assert rec["mesh"] == "2x4" and rec["chips"] == 8 and rec["kind"] == kind
    roof = rec["roofline"]
    for k in TERMS:
        assert math.isfinite(roof[k]) and roof[k] >= 0, k
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert math.isfinite(rec["model_flops_ratio"])
    assert math.isfinite(rec["roofline_fraction"])
    assert rec["trace_s"] > 0
    fsdp = kind == "train"
    assert rec["knobs"]["fsdp"] is fsdp
    assert rec["memory"]["argument_bytes"] == _expected_argument_bytes(
        arch, kind, 64, 8, fsdp)
    jcfg = jreduced(jget_config(arch), fsdp=fsdp)
    assert rec["model_flops_per_device"] == jrf.model_flops(
        jcfg, JShape(f"t_{kind}", 64, 8, kind), 8)
    counts = roof["collective_counts"]
    if kind == "train":
        assert counts.get("all-gather", 0) > 0
        assert counts.get("reduce-scatter", 0) + counts.get(
            "all-reduce", 0) > 0
        assert roof["collective_bytes"] > 0


# The JAX dry run's records of the same cells, on a 2x4 mesh of 8 host
# devices (the device count is fixed when JAX starts, so in a subprocess).
# Its "naive" attention: with "chunked" this JAX's host partitioner runs
# each device's attention on every head and batch row (its "involuntary
# full rematerialization"), 8x the partitioned products.  Its production
# mesh builder makes axes that this JAX takes as explicit, so the mesh is
# made with automatic axes here.
_JAX_CELLS = r"""
import json, os, sys
import jax
assert len(jax.devices()) == 8
from repro.configs import get_config, reduced
from repro.configs.base import ShapeConfig
from repro.launch import dryrun as jd
kw = {}
if hasattr(jax.sharding, "AxisType"):
    kw["axis_types"] = (jax.sharding.AxisType.Auto,) * 2
jd.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 4), ("data", "model"), **kw)
jd.get_config = lambda arch: reduced(get_config(arch), fsdp=True)
out = {}
for cell in sys.argv[1:]:
    arch, kind = cell.split("/")
    jd.SHAPES = {"t_" + kind: ShapeConfig("t_" + kind, 64, 8, kind)}
    rec = jd.run_cell(arch, "t_" + kind, multi_pod=False, save=False,
                      verbose=False, attn_impl="naive")
    out[cell] = rec["roofline"]
print(json.dumps(out))
"""

# port / JAX, per device: (low, high) for every cell, and the named
# departures beyond them.  flops: the same products on the same shards
# (the port's flash backward also recomputes Q.K^T: train +5-9%).  bytes:
# two yardsticks, eager op surfaces against the fused HLO's.  collectives:
# DTensor and GSPMD pick other ops (a reduce-scatter for XLA's all-reduce
# and slice, no collective-permute), so their total count.
JAX_BANDS = {"flops_per_device": (0.95, 1.10),
             "bytes_per_device": (0.45, 1.15),
             "collective_bytes": (0.70, 1.20),
             "collective_count": (0.75, 1.50)}
JAX_DEPARTURES = {
    # the port's decode moves each layer's cache from its kv_seq split to
    # the heads' by all-to-all; JAX attends on the kv_seq shards and
    # all-reduces the partial results
    ("llama3-8b", "decode", "collective_bytes"): (5.0, 8.0),
}
JAX_CELLS = [("llama3-8b", "train"), ("llama3-8b", "prefill"),
             ("llama3-8b", "decode"), ("granite-moe-3b-a800m", "train")]


@pytest.fixture(scope="module")
def jax_records():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(root / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    run = subprocess.run(
        [sys.executable, "-c", _JAX_CELLS]
        + [f"{a}/{k}" for a, k in JAX_CELLS],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", JAX_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_per_device_counts_match_jax(records, jax_records, cell):
    """One device's flops, bytes, collective bytes and collective count
    against the JAX dry run's on the same cell and mesh, within
    ``JAX_BANDS`` or the cell's named departure."""
    arch, kind = cell
    mine = records[1][cell]["roofline"]
    theirs = jax_records[f"{arch}/{kind}"]
    for key in JAX_BANDS:
        if key == "collective_count":
            ratio = (sum(mine["collective_counts"].values())
                     / sum(theirs["collective_counts"].values()))
        else:
            ratio = mine[key] / theirs[key]
        lo, hi = JAX_DEPARTURES.get((arch, kind, key), JAX_BANDS[key])
        assert lo <= ratio <= hi, (key, ratio, mine[key if key in mine
                                                   else "collective_counts"],
                                   theirs[key if key in theirs
                                          else "collective_counts"])


def test_records_read_back(records):
    """The written records: one file per cell, the roofline table's rows
    and finite NVM verdicts from ``analyze_dryrun_dir``."""
    out_dir, recs = records
    files = sorted(out_dir.glob("*__t.json"))
    assert len(files) == len(CELLS)
    assert json.loads(files[0].read_text())["tag"] == "t"
    rows = roofline_table.rows(out_dir, "t")
    assert len(rows) == len(CELLS)
    table = roofline_table.fmt("t", results_dir=out_dir)
    assert table.count("\n") == len(CELLS) + 1 and "| llama3-8b |" in table
    verdicts = analyze_dryrun_dir(str(out_dir), tag="t", device="cpu")
    assert len(verdicts) == len(CELLS)
    for v in verdicts:
        for ratio in (v.energy_ratio, v.edp_ratio):
            assert all(math.isfinite(x) and x > 0 for x in ratio.values())


def test_cli_writes_its_records(tmp_path, monkeypatch):
    """``main`` over a reduced llama3 on the 2x4 mesh (the production
    meshes and the full config swapped for small ones) writes one record
    a mesh and skips them when asked."""
    small = reduced(get_config("llama3-8b"))
    monkeypatch.setattr(dr, "get_config", lambda arch: small)
    monkeypatch.setattr(dr, "SHAPES", {"prefill_32k": ShapeConfig(
        "prefill_32k", 32, 8, "prefill")})
    monkeypatch.setattr(dr, "PRODUCTION_MESHES", {
        False: {"data": 2, "model": 4}, True: {"pod": 2, "data": 2}})
    args = ["--arch", "llama3-8b", "--shape", "prefill_32k", "--mesh", "both",
            "--results-dir", str(tmp_path)]
    dr.main(args)
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == ["llama3-8b__prefill_32k__2x2__baseline.json",
                     "llama3-8b__prefill_32k__2x4__baseline.json"]
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["chips"] == 4 and rec["kind"] == "prefill"
    dr.main(args + ["--skip-existing"])
    assert not dist.is_initialized()


def test_greedy_redistribution_is_restored():
    """The three-axis meshes' greedy planner is swapped in for the body
    only."""
    from torch.distributed.tensor import _redistribute as red
    before = red.DTensorRedistributePlanner.generate_graph_based_transform_infos
    with dr.greedy_redistribution():
        assert (red.DTensorRedistributePlanner
                .generate_graph_based_transform_infos is not before)
    assert (red.DTensorRedistributePlanner
            .generate_graph_based_transform_infos is before)


def test_an_op_with_no_strategy_runs_on_the_replicas():
    """An op DTensor has no strategy for (``renorm`` here) runs on the
    replicated tensors' local copies: its output is a replicated DTensor,
    the op is listed in ``replicated``, and only the successful attempt's
    gathers are counted (one a sharded mesh dim of its one DTensor
    operand)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.graph_analysis import OpCounter
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    with fake_process_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        counter = OpCounter(per_shard=True)
        with counter, implicit_replication():     # as the dry run
            out = torch.renorm(x, 2, 0, 1.0)
        assert isinstance(out, DTensor)
        assert tuple(out.placements) == (Replicate(), Replicate())
        assert tuple(out.shape) == (8, 32)
    assert counter.replicated == {"renorm": 1}
    assert counter.stats.collectives.op_counts == {"all-gather": 2}
    assert counter.stats.bytes_by_op["renorm"] > 0


def test_a_kernel_on_dtensors_declares_its_local_traffic():
    """``FlashAttention`` on DTensors (batch over "data", heads over
    "model" of a fake 2x4 mesh; 8 query heads, 2 kv heads) runs the kernel
    wrapper once per device on the local shards: its declared flops are
    the local call's, with the kv heads repeated twice so that each
    device holds one for its two query heads."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.kernels import ops
    from repro_torch.launch.graph_analysis import OpCounter
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    from repro_torch.models.attention import FlashAttention
    B, S, H, K, hd = 4, 16, 8, 2, 16
    with fake_process_group(8), ops.plain_on_meta():
        mesh = make_mesh((2, 4), ("data", "model"))

        def dt(shape, local, pl):
            return DTensor.from_local(
                torch.empty(local, device="meta"), mesh, pl,
                run_check=False, shape=torch.Size(shape),
                stride=torch.empty(shape, device="meta").stride())

        q = dt((B, S, H, hd), (B // 2, S, H // 4, hd), [Shard(0), Shard(2)])
        k = dt((B, S, K, hd), (B // 2, S, K, hd), [Shard(0), Replicate()])
        counter = OpCounter(per_shard=True)
        with counter:
            o = FlashAttention.apply(q, k, k, True, 0, 0.0, 8, 0, None,
                                     False)
        assert isinstance(o, DTensor) and tuple(o.shape) == (B, S, H, hd)
        assert tuple(o.placements) == (Shard(0), Shard(2))
    assert counter.stats.kernel_calls == {"flash_attention": 1}
    local = (B // 2, H // 4, S, S, hd)           # one kv head a device
    assert counter.stats.flops_by_op["flash_attention"] == \
        4.0 * math.prod(local)
    assert not dist.is_initialized()


def test_a_program_error_under_dtensors_raises():
    """Only DTensor's refusals to place an op are retried replicated: an
    error of the program (here a shape mismatch) propagates."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch.graph_analysis import OpCounter
    from repro_torch.launch.mesh import fake_process_group, make_mesh
    with fake_process_group(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        a = DTensor.from_local(torch.empty(2, 8, device="meta"), mesh,
                               [Shard(0), Shard(1)], run_check=False)
        counter = OpCounter(per_shard=True)
        with counter, pytest.raises(RuntimeError) as err:
            torch.mm(a, a)
        assert "Sharding propagation failed" not in str(err.value)
    assert counter.replicated == {}
    assert not dist.is_initialized()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scans_on_meta_give_the_plain_versions_shapes(dtype):
    """Inside ``plain_on_meta`` the scan wrappers return outputs of the
    plain versions' shapes and dtypes without walking their steps; outside
    it a ``meta`` tensor still raises."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rglru_scan as rg
    B, S, R = 2, 4096, 8
    a, b = (torch.empty(B, S, R, dtype=dtype, device="meta") for _ in "ab")
    h0 = torch.empty(B, R, device="meta")
    lam = torch.empty(R, dtype=dtype, device="meta")
    with ops.plain_on_meta():
        got = ops.rglru_scan(a.float(), b.float(), h0)
        gated = ops.rglru_gated_scan(a, b, a, lam, None)
    want = rg.rglru_scan_plain(a.float()[:, :3], b.float()[:, :3], h0)
    want_g = rg.rglru_gated_scan_plain(a[:, :3], b[:, :3], a[:, :3], lam)
    for g, w in zip(got + gated, want + want_g):
        assert g.device.type == "meta" and g.dtype == w.dtype
        assert g.shape[0] == w.shape[0] and g.shape[-1] == w.shape[-1]
    assert got[0].shape == (B, S, R) and gated[0].shape == (B, S, R)
    x = torch.empty(B, S, 4, 8, dtype=dtype, device="meta")
    dt_, Bm = torch.empty(B, S, 4, device="meta"), torch.empty(
        B, S, 16, device="meta")
    with ops.plain_on_meta():
        y, state = ops.ssd_scan(x, dt_.to(dtype), dt_.to(dtype),
                                Bm.to(dtype), Bm.to(dtype), chunk=256)
    assert y.shape == x.shape and y.dtype == dtype
    assert state.shape == (B, 4, 8, 16) and state.dtype == torch.float32
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rglru_scan(a.float(), b.float(), h0)
