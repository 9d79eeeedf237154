"""The port's sharding slice against the JAX package's, on the CPU.

``repro_torch.sharding`` (rule tables, ``spec_for`` on every parameter,
cache and paged-cache leaf of the ten full-size configs on both
production meshes and both strategies, the JAX hypothesis property),
``train.elastic`` (``choose_mesh``, ``plan_recovery``, ``remesh`` on a
fake group), the abstract train state and its logical axes (AdamW with
and without master weights, the EF-int8 ``CompressedOptimizer`` at 1 and
4 shards), the collective counter against JAX's ``parse_collectives`` of
the same op, ``compressed_psum_ef(group=)`` over 3 gloo ranks against the
stacked form bit for bit, a reduced llama3 loss on a 1x1 gloo mesh with
DTensor weights under ``activation_sharding`` against the plain loss,
and the train launcher's mesh setup for both strategies.  Every test
leaves ``torch.distributed`` uninitialised.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo as janalyze_hlo  # noqa: E402
from repro.launch.roofline import parse_collectives as jparse  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402
from repro.optim import AdamW as JAdamW, constant as jconstant  # noqa: E402
from repro.optim.compress import wrap_optimizer as jwrap  # noqa: E402
from repro.sharding.rules import default_rules as jdefault_rules  # noqa: E402
from repro.sharding.rules import spec_for as jspec_for  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro.train.trainer import abstract_state as jabstract_state  # noqa: E402
from repro.train.trainer import state_axes as jstate_axes  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import roofline as rf  # noqa: E402
from repro_torch.launch.mesh import (fake_process_group, make_mesh,  # noqa: E402
                                     mesh_shape_for, process_group)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW, constant  # noqa: E402
from repro_torch.optim import compress as tc  # noqa: E402
from repro_torch.sharding import (PartitionSpec, activation_sharding,  # noqa: E402
                                  constrain, default_rules, placements,
                                  spec_for)
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train.trainer import abstract_state, state_axes  # noqa: E402

MESH16 = {"data": 16, "model": 16}
MESH512 = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture(autouse=True)
def _no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


# --- rule tables and specs --------------------------------------------------


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("seq_parallel", [True, False])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("fsdp", [True, False])
def test_default_rules_equal_jax(fsdp, multi_pod, seq_parallel, strategy):
    kw = dict(fsdp=fsdp, multi_pod=multi_pod, seq_parallel=seq_parallel,
              strategy=strategy)
    assert default_rules(**kw) == jdefault_rules(**kw)


def _leaves(cfg):
    """(what, {name: (axes, shape)}) of the weights, the decode cache and
    (for the paged families) the paged cache, from the JAX model and
    the port's, after checking that they agree."""
    jm = jbuild_model(cfg, max_seq=4096)
    tm = build_model(get_config(cfg.arch), max_seq=4096, device="cpu")
    B, L = 128, 32768
    out = [("params", jm.param_axes(), jm.abstract_params(),
            tm.param_axes(), tm.abstract_params()),
           ("cache", jm.cache_axes(B, L), jm.abstract_cache(B, L),
            tm.cache_axes(B, L), tm.abstract_cache(B, L))]
    if "paged" in tm.serve_modes:
        jd, td = jm.paged_cache_defs(4097, 16), tm.paged_cache_defs(4097, 16)
        out.append(("paged", jm.paged_cache_axes(4097, 16),
                    {n: d for n, d in jd.items()},
                    tm.paged_cache_axes(4097, 16),
                    {n: d for n, d in td.items()}))
    leaves = {}
    for what, jax_axes, jshapes, t_axes, tshapes in out:
        assert t_axes == jax_axes, what
        assert sorted(tshapes) == sorted(jshapes), what
        for n in jshapes:
            assert tuple(tshapes[n].shape) == tuple(jshapes[n].shape), n
        leaves[what] = {n: (jax_axes[n], tuple(jshapes[n].shape))
                        for n in jshapes}
    return leaves


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
@pytest.mark.parametrize("arch", jlist_archs())
def test_spec_for_every_leaf_equals_jax(arch, strategy):
    """``spec_for`` equals JAX's, as tuples, for every weight, decode-cache
    and paged-cache leaf of the full-size config on both production
    meshes (the weights with the config's fsdp, as the train cells, and
    without, as the serve cells)."""
    cfg = jget_config(arch)
    checked = 0
    for what, leaves in _leaves(cfg).items():
        for mesh in (MESH16, MESH512):
            for fsdp in ((cfg.fsdp, False) if what == "params" else
                         (False,)):
                kw = dict(fsdp=fsdp, multi_pod="pod" in mesh,
                          strategy=strategy)
                rules, jrules = default_rules(**kw), jdefault_rules(**kw)
                for name, (axes, shape) in leaves.items():
                    got = spec_for(axes, shape, mesh, rules)
                    assert isinstance(got, PartitionSpec)
                    assert tuple(got) == tuple(
                        jspec_for(axes, shape, mesh, jrules)), (what, name)
                    checked += 1
    assert checked > 40


@given(dims=st.lists(st.sampled_from([1, 2, 3, 8, 16, 40, 64, 128, 256]),
                     min_size=1, max_size=4),
       names=st.lists(st.sampled_from(["batch", "heads", "ffn", "vocab",
                                       "kv_seq", "experts", None]),
                      min_size=1, max_size=4))
@settings(max_examples=100, deadline=None)
def test_spec_never_violates_divisibility(dims, names):
    """The JAX package's property on the port's ``spec_for``, and the two
    give the same spec."""
    n = min(len(dims), len(names))
    dims, names = tuple(dims[:n]), tuple(names[:n])
    rules = default_rules()
    spec = spec_for(names, dims, MESH16, rules)
    assert tuple(spec) == tuple(jspec_for(names, dims, MESH16,
                                          jdefault_rules()))
    used = []
    for dim, ax in zip(dims, tuple(spec) + (None,) * (n - len(spec))):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else ax
        size = int(np.prod([MESH16[a] for a in axes]))
        assert dim % size == 0
        used += list(axes)
    assert len(used) == len(set(used))


def test_placements_of_specs():
    """A spec's DTensor placements on a mesh: Shard(i) on each mesh dim a
    dim is split over (a two-axis group on both, in the mesh's order),
    Replicate elsewhere; a group against the mesh's order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    with fake_process_group(512):
        mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
        assert placements(PartitionSpec(("pod", "data"), None, "model"),
                          mesh) == (Shard(0), Shard(0), Shard(2))
        assert placements(PartitionSpec(), mesh) == (Replicate(),) * 3
        assert placements(PartitionSpec(None, ("data", "model")), mesh) == (
            Replicate(), Shard(1), Shard(1))
        with pytest.raises(ValueError, match="order"):
            placements(PartitionSpec(("model", "data")), mesh)


def test_constrain_is_the_identity_without_a_sharder_or_a_dtensor():
    x = torch.ones(4, 8)
    assert constrain(x, ("batch", "seq")) is x
    with process_group("gloo"):
        mesh = make_mesh((1, 1), ("data", "model"))
        with activation_sharding(mesh, default_rules()):
            assert constrain(x, ("batch", "seq")) is x


# --- elastic ----------------------------------------------------------------


def test_choose_mesh_and_plan_recovery_equal_jax():
    for n in range(1, 601):
        assert dataclasses.astuple(elastic.choose_mesh(n)) == \
            dataclasses.astuple(jelastic.choose_mesh(n)), n
    for kind in ("failure", "straggler", "scale_up"):
        for n in (1, 7, 24, 256, 496, 512):
            got = elastic.plan_recovery(elastic.ElasticEvent(kind, [3], n))
            want = jelastic.plan_recovery(jelastic.ElasticEvent(kind, [3], n))
            assert dataclasses.astuple(got[0]) == \
                dataclasses.astuple(want[0]) and got[1] == want[1]


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_on_a_fake_group(multi_pod):
    from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
    want = MESH512 if multi_pod else MESH16
    with fake_process_group(512 if multi_pod else 256):
        assert mesh_axis_sizes(make_production_mesh(
            multi_pod=multi_pod)) == want


REMESH = {1: ((1, 1), ("data", "model")), 8: ((1, 8), ("data", "model")),
          48: ((3, 16), ("data", "model")),
          256: ((2, 8, 16), ("pod", "data", "model")),
          512: ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("n", sorted(REMESH))
def test_remesh_on_a_fake_group(n):
    """``remesh`` builds the ladder's mesh (JAX's ``make_mesh_for`` shape
    rule) on a group of n ranks."""
    c = elastic.choose_mesh(n)
    assert mesh_shape_for(n, model_parallelism=c.model_parallelism,
                          pods=c.pods) == REMESH[n]
    with fake_process_group(n):
        mesh = elastic.remesh(n)
        assert (tuple(mesh.shape), tuple(mesh.mesh_dim_names)) == REMESH[n]


# --- abstract state ---------------------------------------------------------


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


OPTS = {
    "adamw": (lambda: AdamW(lr=constant(1e-3)),
              lambda: JAdamW(lr=jconstant(1e-3))),
    "adamw no master": (
        lambda: AdamW(lr=constant(1e-3), master_weights=False),
        lambda: JAdamW(lr=jconstant(1e-3), master_weights=False)),
    "compressed 1": (lambda: tc.wrap_optimizer(AdamW(lr=constant(1e-3))),
                     lambda: jwrap(JAdamW(lr=jconstant(1e-3)))),
    "compressed 4": (
        lambda: tc.wrap_optimizer(AdamW(lr=constant(1e-3)), shards=4),
        lambda: jwrap(JAdamW(lr=jconstant(1e-3)), shards=4)),
}


@pytest.mark.parametrize("opt", sorted(OPTS))
@pytest.mark.parametrize("arch", ["llama3-8b", "granite-moe-3b-a800m"])
def test_abstract_state_and_axes_equal_jax(arch, opt):
    cfg = jreduced(jget_config(arch))
    jm = jbuild_model(cfg, max_seq=64)
    tm = build_model(reduced(get_config(arch)), max_seq=64, device="cpu")
    mk, jmk = OPTS[opt]
    st, jst = _flat(abstract_state(tm, mk())), _flat(jabstract_state(jm, jmk()))
    assert sorted(st) == sorted(jst)
    for name, leaf in st.items():
        assert leaf.device.type == "meta", name
        assert tuple(leaf.shape) == tuple(jst[name].shape), name
        assert str(leaf.dtype).split(".")[-1] == str(jst[name].dtype), name
    is_axes = (lambda x: isinstance(x, tuple))
    ax = state_axes(tm, mk())
    jax_ax = jstate_axes(jm, jmk())

    def flat_axes(tree, prefix=""):
        if is_axes(tree):
            return {prefix: tuple(tree)}
        out = {}
        for k, v in tree.items():
            out.update(flat_axes(v, f"{prefix}/{k}" if prefix else k))
        return out

    assert flat_axes(ax) == flat_axes(jax_ax)
    if opt == "compressed 4":
        assert all(a[0] == "batch" for n, a in flat_axes(ax).items()
                   if n.startswith("opt/err/"))


# --- collectives ------------------------------------------------------------


def _attrs(op: str, n: int) -> str:
    if op == "collective-permute":
        return "source_target_pairs={{0,1},{1,0}}"
    extra = ", to_apply=%add" if op in ("all-reduce", "reduce-scatter") \
        else ", dimensions={0}"
    return f"replica_groups=[1,{n}]<=[{n}]{extra}"


@pytest.mark.parametrize("n", [2, 4, 16])
def test_collective_counts_equal_jax_parse_collectives(n):
    """One collective of each kind on a fake group of n ranks, counted as
    it reaches the dispatcher, equals JAX's ``parse_collectives`` of an
    HLO line with the same op, output shape and group size (count, ring
    link bytes, payload), and the walker's ``analyze_hlo`` of the same
    instruction in a module.  ``parse_collectives`` reads the output
    shape left of the line's first '=', so its line is written
    ``shape = op(...)``."""
    import torch.distributed._functional_collectives as funcol
    rows = 8 * n
    x = torch.zeros(rows, 16)
    cases = {
        "all-gather": (lambda g: funcol.all_gather_single(x, 0, g),
                       (rows * n, 16)),
        "reduce-scatter": (
            lambda g: funcol.reduce_scatter_single(x, "sum", 0, g),
            (rows // n, 16)),
        "all-reduce": (lambda g: funcol.all_reduce(x, "sum", g), (rows, 16)),
        "all-to-all": (lambda g: funcol.all_to_all_single(x, None, None, g),
                       (rows, 16)),
        # permute_tensor splits by element count: a flat tensor
        "collective-permute": (
            lambda g: funcol.permute_tensor(x.reshape(-1), [
                (i + 1) % n for i in range(n)], g), (rows * 16,)),
    }
    with fake_process_group(n):
        group = dist.group.WORLD
        for op, (run, out_shape) in cases.items():
            with rf.parse_collectives() as got:
                out = run(group)
                if hasattr(out, "wait"):
                    out = out.wait()
            o = ",".join(map(str, out_shape))
            lay = "{1,0}" if len(out_shape) == 2 else "{0}"
            want = jparse(f"f32[{o}]{lay} = {op}(%x), {_attrs(op, n)}")
            assert got.op_counts == want.op_counts == {op: 1}
            assert got.op_bytes == pytest.approx(want.op_bytes, rel=1e-12)
            assert got.raw_bytes == pytest.approx(want.raw_bytes, rel=1e-12)
            walker = janalyze_hlo(
                f"ENTRY %main (x: f32[{rows},16]) -> f32[{o}] {{\n"
                f"  %x = f32[{rows},16]{{1,0}} parameter(0)\n"
                f"  ROOT %c = f32[{o}]{lay} {op}(%x), {_attrs(op, n)}\n"
                f"}}\n")
            assert walker.collective_counts == got.op_counts
            assert walker.collective_bytes_by_op == pytest.approx(
                got.op_bytes, rel=1e-12)
            assert got.total_bytes == pytest.approx(
                walker.collective_link_bytes)


def test_analyze_builds_the_roofline_with_collectives():
    from repro_torch.launch.graph_analysis import OpStats
    stats = OpStats()
    stats.add("mm", 2e12, 4e9)
    stats.collectives.add("all-gather", 16, 1.6e9)
    stats.collectives.add("all-reduce", 4, 1e6)
    roof = rf.analyze(stats)
    assert roof.collective_bytes == pytest.approx(
        1.6e9 * 15 / 16 + 1e6 * 2 * 3 / 4)
    assert roof.collective_counts == {"all-gather": 1, "all-reduce": 1}
    d = roof.to_dict()
    assert d["collectives"] == roof.collectives
    assert d["collective_s"] == pytest.approx(roof.collective_bytes
                                              / rf.ICI_BW)


# --- compressed_psum_ef over a process group ---------------------------------


def _psum_rank(rank, world, path):
    import torch.distributed as d
    from repro_torch.optim import compress as c
    d.init_process_group("gloo", store=d.FileStore(path, world), rank=rank,
                         world_size=world)
    try:
        rng = np.random.default_rng(7)
        stacked = {"a": torch.from_numpy(
            (rng.standard_normal((world, 33, 5)) * 3).astype(np.float32)),
            "b": torch.from_numpy(
                rng.standard_normal((world, 17)).astype(np.float32)
            ).to(torch.bfloat16)}
        for mean in (False, True):
            want, werr = c.compressed_psum_ef(stacked, mean=mean)
            mine = {k: v[rank].clone() for k, v in stacked.items()}
            got, err = c.compressed_psum_ef(mine, mean=mean,
                                            group=d.group.WORLD)
            only = c.compressed_psum(mine, mean=mean, group=d.group.WORLD)
            for k in stacked:
                assert got[k].dtype == want[k].dtype
                assert torch.equal(got[k].view(-1).view(torch.uint8),
                                   want[k].view(-1).view(torch.uint8)), k
                assert torch.equal(only[k], want[k]), k
                assert torch.equal(err[k], werr[k][rank]), k
    finally:
        d.destroy_process_group()


def test_compressed_psum_ef_over_gloo_ranks_is_the_stacked_form(tmp_path):
    """3 gloo ranks, each holding its shard: the combined value (sum and
    mean) and each rank's residual equal the stacked-axis version's bit
    for bit."""
    import torch.multiprocessing as mp
    mp.spawn(_psum_rank, args=(3, str(tmp_path / "store")), nprocs=3,
             join=True)


# --- DTensor weights on a 1x1 mesh ------------------------------------------


def test_loss_on_a_1x1_mesh_with_dtensor_weights_equals_the_plain_loss():
    """Reduced llama3: the weights and the batch as DTensors on a 1x1
    gloo mesh, ``constrain`` active, give the plain loss."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    cfg = reduced(get_config("llama3-8b"), dtype="float32")
    model = build_model(cfg, max_seq=32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    plain = model.loss(params, batch)
    with process_group("gloo"):
        mesh = make_mesh((1, 1), ("data", "model"))
        rules = default_rules()

        def dt(x):
            return DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                                      run_check=False)

        with activation_sharding(mesh, rules), implicit_replication():
            loss = model.loss({k: dt(v) for k, v in params.items()},
                              {k: dt(v) for k, v in batch.items()})
        assert isinstance(loss, DTensor)
        assert torch.equal(loss.full_tensor(), plain)


# --- the launcher's mesh ----------------------------------------------------


@pytest.mark.parametrize("strategy", ["tp", "fsdp"])
def test_train_launcher_mesh_setup(strategy, capsys):
    """The train launcher's mesh setup in process: a one-rank gloo group,
    the 1x1 ladder mesh printed, every state spec empty under either
    strategy, the group gone afterwards."""
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import launcher_mesh
    from repro_torch.train.trainer import effective_optimizer
    cfg = reduced(get_config("llama3-8b"))
    model = build_model(cfg, max_seq=32, device="cpu")
    opt = effective_optimizer(AdamW(lr=constant(1e-3)), True, 2)
    with launcher_mesh("cpu") as (mesh, choice):
        assert dist.get_backend() == "gloo"
        assert tuple(mesh.shape) == (1, 1) and choice.model_parallelism == 1
        rules = launcher.state_rules(model, opt, mesh, strategy)
        assert rules == default_rules(fsdp=cfg.fsdp, strategy=strategy)
    assert ("devices=1 mesh={'data': 1, 'model': 1} (model_parallelism=1)"
            in capsys.readouterr().out)
    with fake_process_group(256):
        mesh = make_mesh((16, 16), ("data", "model"))
        with pytest.raises(ValueError, match="would be sharded"):
            launcher.state_rules(build_model(get_config("llama3-8b"),
                                             device="cpu"), opt, mesh,
                                 strategy)


def test_serve_launcher_mesh_opens_no_group(capsys):
    """The serve launcher's mesh: the elastic ladder's axis sizes, printed
    as the train launcher prints its own, with no process group opened
    (nothing on the serve path reads a mesh)."""
    from repro_torch.launch.mesh import ladder_mesh_sizes
    assert ladder_mesh_sizes(1) == {"data": 1, "model": 1}
    assert not dist.is_initialized()
    assert ("devices=1 mesh={'data': 1, 'model': 1} (model_parallelism=1)"
            in capsys.readouterr().out)
    assert ladder_mesh_sizes(512) == {"pod": 2, "data": 16, "model": 16}
    assert ladder_mesh_sizes(48) == {"data": 3, "model": 16}
