"""The port's DeepNVM++ pipeline (``repro_torch.core``) against the JAX
package (``repro.core``), on the CPU.

Tolerances: PPA, traffic, energy and the iso/scaling results within
rel 1e-6 (both sides compute in float32; the JAX tests hold the batched
engines to their float64/per-point references at the same bound);
Algorithm-1 selections and iso-area capacities identical; gradients of the
calibration and claim losses within rtol 1e-4 of ``jax.grad`` (float32,
another order of operations); the framework-free modules field for field.
"""
import dataclasses
import importlib
import io
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

import repro.core as jcore
from repro.core import bitcell as jbitcell
from repro.core import cache_model as jcm
from repro.core import constants as jconstants
from repro.core import dram as jdram
from repro.core import energy as jenergy
from repro.core import iso as jiso
from repro.core import profiles as jprofiles
from repro.core import scaling as jscaling
from repro.core import table2 as jtable2
from repro.core import traffic as jtraffic
from repro.core import tuner as jtuner
from repro.core import workloads as jworkloads
from repro.launch import roofline as jroofline
import repro_torch.core as core
from repro_torch.core import (bitcell, cache_model, cachesim, constants, dram,
                              energy, iso, profiles, scaling, table2, traffic,
                              tuner, workloads)
from repro_torch.examples import quickstart
from repro_torch.launch import roofline

# the packages' __init__ rebind ``core.sweep`` to the function
sweep = importlib.import_module("repro_torch.core.sweep")
jsweep = importlib.import_module("repro.core.sweep")
CPU = "cpu"
REL = 1e-6
GRAD_RTOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if k.isupper() and not k.startswith("_")}


def _close(a, b, rel=REL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rel, atol=0)


def _same_ppa(p, q, rel=REL):
    assert (p.mem, p.capacity_mb, p.banks, p.rows, p.access_type) == \
        (q.mem, q.capacity_mb, q.banks, q.rows, q.access_type)
    for f in cache_model.PPA_METRICS:
        assert getattr(p, f) == pytest.approx(getattr(q, f), rel=rel), f


# --- framework-free copies ---------------------------------------------------


@pytest.mark.parametrize("mod,jmod", [
    (constants, jconstants), (bitcell, jbitcell), (table2, jtable2),
    (workloads, jworkloads), (cache_model, jcm), (traffic, jtraffic),
    (tuner, jtuner)], ids=lambda m: m.__name__.split(".")[-1])
def test_module_constants_equal_the_reference(mod, jmod):
    mine, ref = _public(mod), _public(jmod)
    assert ref.keys() <= mine.keys()
    for k in ref:
        a, b = mine[k], ref[k]
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), k
        elif isinstance(b, dict) and b and \
                dataclasses.is_dataclass(next(iter(b.values()))):
            assert {n: dataclasses.asdict(v) for n, v in a.items()} == \
                {n: dataclasses.asdict(v) for n, v in b.items()}, k
        else:
            assert a == b, k


def test_bitcell_flow_equals_the_reference():
    for sot, dev, jdev in ((False, bitcell.STT_DEVICE, jbitcell.STT_DEVICE),
                           (True, bitcell.SOT_DEVICE, jbitcell.SOT_DEVICE)):
        assert dataclasses.asdict(dev) == dataclasses.asdict(jdev)
        mine = bitcell.fin_sweep(dev, sot=sot)
        ref = jbitcell.fin_sweep(jdev, sot=sot)
        assert [dataclasses.asdict(c) for c in mine] == \
            [dataclasses.asdict(c) for c in ref]
        assert [c.write_energy_pj for c in mine] == \
            [c.write_energy_pj for c in ref]


def test_workload_descriptors_equal_the_reference():
    for name, net in jworkloads.NETWORKS.items():
        mine = workloads.NETWORKS[name]
        assert [dataclasses.asdict(l) for l in mine.layers] == \
            [dataclasses.asdict(l) for l in net.layers]
        assert (mine.total_weights, mine.total_macs, mine.conv_layers,
                mine.fc_layers) == (net.total_weights, net.total_macs,
                                    net.conv_layers, net.fc_layers)
    for name, w in jworkloads.HPCG.items():
        assert workloads.HPCG[name].transactions() == w.transactions()


def test_dram_model_and_dtype_table_equal_the_reference():
    caps = (0.5, 3, 6, 7, 10, 12, 24, 64)
    assert [dram.dram_scale(c) for c in caps] == \
        [jdram.dram_scale(c) for c in caps]
    assert dram.fig7_curve() == jdram.fig7_curve()
    assert dram.reduction_pct_from_misses(80, 100) == \
        jdram.reduction_pct_from_misses(80, 100)
    assert roofline._DTYPE_BYTES == jroofline._DTYPE_BYTES
    assert roofline._DTYPE_ALIASES == jroofline._DTYPE_ALIASES
    for name in ("bfloat16", "float32", "f8e5m2", "s32"):
        assert roofline.dtype_bytes(name) == jroofline.dtype_bytes(name)
    with pytest.raises(KeyError, match="unknown dtype"):
        roofline.dtype_bytes("complex7")


def test_core_exports_mirror_the_reference():
    assert core.__all__ == jcore.__all__


# --- cache model, sweep, tuner -----------------------------------------------


def test_evaluate_batch_matches_jax():
    cells = [bitcell.TABLE1[m] for m in ("SRAM", "STT", "SOT")]
    caps = (0.5, 1.0, 3.0, 7.0, 10.0, 11.3137, 32.0, 64.0)
    grid = cache_model.evaluate_batch(cache_model.cell_arrays(cells, CPU),
                                      caps)
    jgrid = jcm.evaluate_batch(jcm.cell_arrays(cells),
                               jnp.asarray(caps, jnp.float32))
    for k in cache_model.PPA_METRICS:
        assert grid[k].dtype == torch.float32
        assert tuple(grid[k].shape) == (3, len(caps), 7, 5, 3)
        _close(grid[k].numpy(), jgrid[k])


def test_design_grid_and_config_match_jax():
    mine = cache_model.design_grid("STT", 7.0, device=CPU)
    ref = jcm.design_grid("STT", 7.0)
    assert len(mine) == len(ref) == 105
    for p, q in zip(mine, ref):
        _same_ppa(p, q)
    _same_ppa(cache_model.evaluate_config("SOT", 10.0, 16, 1024, "Fast",
                                          device=CPU),
              jcm.evaluate_config("SOT", 10.0, 16, 1024, "Fast"))


@pytest.fixture(scope="module")
def tuned_all():
    return tuner.tune_all(device=CPU), jtuner.tune_all()


@pytest.mark.parametrize("mem", tuner.MEMORIES)
def test_tune_all_selections_match_jax_and_reference(tuned_all, mem):
    mine, ref = tuned_all
    for cap in tuner.CAPACITIES_MB:
        _same_ppa(mine[mem][cap], ref[mem][cap])
        _same_ppa(tuner.tune_reference(mem, cap, device=CPU),
                  mine[mem][cap])


@pytest.mark.parametrize("key", list(table2.TABLE2_ANCHORS))
def test_table2_anchor_selections_match_jax(key):
    mem, cap = key
    _same_ppa(tuner.tune(mem, cap, device=CPU), jtuner.tune(mem, cap))
    _same_ppa(tuner.tune(mem, cap, cache_model.CAL, device=CPU),
              jtuner.tune(mem, cap, jcm.CAL))


def test_sweep_result_matches_jax():
    caps = (1.0, 3.0, 7.0)
    s = sweep.sweep(("SRAM", "STT", "SOT"), caps, device=CPU)
    j = jsweep.sweep(("SRAM", "STT", "SOT"), caps)
    np.testing.assert_array_equal(s.sel, np.asarray(j.sel))
    assert s.grid.keys() == j.grid.keys()
    for k in j.grid:
        _close(s.grid[k], j.grid[k])
        _close(s.tuned[k], j.tuned[k])
    assert s.selection("STT", 7.0) == j.selection("STT", 7.0)
    with pytest.raises(ValueError, match="not in this sweep"):
        s.config("MRAM", 3.0)


@pytest.mark.parametrize("steps,include", [(2, ()), (1, (3.0,)),
                                           (2, (3.0, 2.0, 0.5))])
def test_capacity_ladder_matches_jax(steps, include):
    assert sweep.capacity_ladder(steps_per_octave=steps, include=include) \
        == jsweep.capacity_ladder(steps_per_octave=steps, include=include)


def test_iso_area_search_matches_jax():
    budget = jtuner.tune("SRAM", 3).area_mm2
    mine = sweep.iso_area_search(("STT", "SOT"), budget, device=CPU)
    ref = jsweep.iso_area_search(("STT", "SOT"), budget)
    for m in ref:
        _same_ppa(mine[m], ref[m])
    _same_ppa(tuner.iso_area_capacity("STT", budget, device=CPU),
              jtuner.iso_area_capacity("STT", budget))
    with pytest.raises(ValueError, match="area budget"):
        sweep.iso_area_search(("SRAM",), 0.01, device=CPU)


def test_iso_capacity_configs_match_jax():
    mine = tuner.iso_capacity_configs(3.0, CPU)
    ref = jtuner.iso_capacity_configs(3.0)
    for m in ref:
        _same_ppa(mine[m], ref[m])


def _calibration_problem():
    fields = dict(rl="read_latency_ns", wl="write_latency_ns",
                  re="read_energy_nj", we="write_energy_nj",
                  lk="leakage_mw", ar="area_mm2")
    targets = {k: {s: v[f] for s, f in fields.items()}
               for k, v in table2.TABLE2_ANCHORS.items()}
    weights = dict(rl=1.2, wl=1.0, re=3.0, we=2.0, lk=1.0, ar=1.5)
    return targets, weights, fields


@pytest.mark.parametrize("perturb", [False, True],
                         ids=["frozen", "perturbed"])
def test_calibration_loss_and_grad_match_jax(perturb):
    """At the frozen constants and at constants moved by up to 10% (which
    moves tuned points; the selection is detached on both sides)."""
    targets, weights, fields = _calibration_problem()
    loss = sweep.make_calibration_loss(targets, weights, fields, CPU)
    jloss = jsweep.make_calibration_loss(targets, weights, fields)
    rng = np.random.default_rng(0)
    vals = {k: float(v) * (float(rng.uniform(0.9, 1.1)) if perturb else 1.0)
            for k, v in jcm.CAL.items()}
    jl, jg = jax.value_and_grad(jloss)(vals)
    cal = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
           for k, v in vals.items()}
    out = loss(cal)
    out.backward()
    assert out.item() == pytest.approx(float(jl), rel=REL)
    for k in cal:
        np.testing.assert_allclose(float(cal[k].grad), float(jg[k]),
                                   rtol=GRAD_RTOL, atol=1e-9, err_msg=k)


# --- traffic and profiles ------------------------------------------------------


@pytest.fixture(scope="module")
def paper_tensors():
    grid = (1, 4, 64, 128)
    return (traffic.compute_traffic(traffic.paper_pack(), grid, device=CPU),
            jtraffic.compute_traffic(jtraffic.paper_pack(), grid))


def test_packs_equal_the_reference():
    for mine, ref in ((traffic.paper_pack(), jtraffic.paper_pack()),
                      (traffic.modern_pack(), jtraffic.modern_pack())):
        assert mine.names == ref.names
        for k in ref.layers:
            np.testing.assert_array_equal(mine.layers[k], ref.layers[k])
        for k in ref.reduced:
            np.testing.assert_array_equal(mine.reduced[k], ref.reduced[k])
        np.testing.assert_array_equal(mine.hpc_mask, ref.hpc_mask)
        np.testing.assert_array_equal(mine.hpc_reads, ref.hpc_reads)


def test_layer_stack_lowering_equals_the_reference():
    from repro.configs import get_config as jget_config
    from repro_torch.configs import get_config, list_archs
    for arch in list_archs():
        mine = traffic.LayerStack.from_config(get_config(arch), 256)
        ref = jtraffic.LayerStack.from_config(jget_config(arch), 256)
        assert mine.name == ref.name
        assert [dataclasses.astuple(l) for l in mine.layers] == \
            [dataclasses.astuple(l) for l in ref.layers], arch


def test_compute_traffic_matches_jax(paper_tensors):
    mine, ref = paper_tensors
    assert mine.names == ref.names and mine.batches == ref.batches
    assert mine.reads.dtype == np.float32
    for f in ("reads", "writes", "dram"):
        _close(getattr(mine, f), getattr(ref, f))


@pytest.mark.parametrize("name", list(jworkloads.NETWORKS))
@pytest.mark.parametrize("mode", ["inference", "training"])
def test_profile_matches_reference_and_jax(name, mode):
    for batch in (4, 64):
        p = profiles.profile(name, mode, batch, device=CPU)
        ref = profiles.profile_reference(name, mode, batch)
        jp = jprofiles.profile(name, mode, batch)
        assert dataclasses.astuple(ref) == dataclasses.astuple(
            jprofiles.profile_reference(name, mode, batch))
        for f in ("l2_reads", "l2_writes", "dram"):
            assert getattr(p, f) == pytest.approx(getattr(ref, f), rel=REL)
            assert getattr(p, f) == pytest.approx(getattr(jp, f), rel=REL)
        assert p.label == jp.label


def test_paper_and_modern_profiles_match_jax():
    for mine, ref in ((profiles.paper_profiles(device=CPU),
                       jprofiles.paper_profiles()),
                      (profiles.dl_profiles(8, 32, device=CPU),
                       jprofiles.dl_profiles(8, 32)),
                      (traffic.modern_profiles(device=CPU),
                       jtraffic.modern_profiles())):
        assert [p.label for p in mine] == [p.label for p in ref]
        for p, q in zip(mine, ref):
            for f in ("l2_reads", "l2_writes", "dram"):
                assert getattr(p, f) == pytest.approx(getattr(q, f),
                                                      rel=REL)


def test_hpc_guards_raise():
    with pytest.raises(ValueError, match="HPC workload"):
        profiles.profile("HPCG-S", "training", 1, device=CPU)
    tt = traffic.compute_traffic(traffic.paper_pack(), (4,), device=CPU)
    with pytest.raises(ValueError, match="HPC workload"):
        tt.profile("HPCG-M", "inference", 4)


def test_claim_loss_and_grad_match_jax():
    """The claim loss and its gradient in the six knobs.  ``jax.grad`` is
    no yardstick here: on the iso-area claims the reference's reverse mode
    disagrees with its own forward mode (``jax.jacfwd``) and with central
    differences of the same function (ROADMAP Queue C).  The port's
    autograd is held to the forward mode within rtol 1e-4, and where the
    forward mode gives NaN (the two DRAM fractions) to a central
    difference of the JAX loss at a relative step of 1e-3, within
    rtol 5e-3 (the float32 rounding of the loss over that step)."""
    loss_fn, claims_fn = traffic.make_claim_loss(device=CPU)
    jloss_fn, jclaims_fn = jtraffic.make_claim_loss()
    jt = {k: jnp.asarray(v, jnp.float32) for k, v in jtraffic.TRAFFIC.items()}
    fwd = jax.jacfwd(jloss_fn)(jt)
    t = {k: torch.tensor(v, dtype=torch.float32, requires_grad=True)
         for k, v in traffic.TRAFFIC.items()}
    out = loss_fn(t)
    out.backward()
    assert out.item() == pytest.approx(float(jloss_fn(jt)), rel=REL)
    for k, v in jtraffic.TRAFFIC.items():
        want, rtol = float(fwd[k]), GRAD_RTOL
        if not np.isfinite(want):
            h = 1e-3 * v
            want = (float(jloss_fn({**jt, k: jnp.float32(v + h)}))
                    - float(jloss_fn({**jt, k: jnp.float32(v - h)}))) / (2 * h)
            rtol = 5e-3
        np.testing.assert_allclose(float(t[k].grad), want, rtol=rtol,
                                   err_msg=k)
    claims, pen = claims_fn(None)
    jclaims, jpen = jclaims_fn(None)
    assert claims.keys() == jclaims.keys() and len(claims) == 13
    for k in claims:
        assert claims[k][0] == pytest.approx(jclaims[k][0], rel=REL)
    assert pen == pytest.approx(jpen, abs=1e-6)


# --- energy, iso, scaling -----------------------------------------------------


def test_energy_matches_jax():
    p = jprofiles.profile_reference("AlexNet", "training", 64)
    cfgs = jtuner.iso_capacity_configs(3.0)
    base = energy.evaluate(p, cfgs["SRAM"])
    jbase = jenergy.evaluate(p, cfgs["SRAM"])
    assert dataclasses.astuple(base) == dataclasses.astuple(jbase)
    assert (base.edp, base.edp_with_dram) == (jbase.edp, jbase.edp_with_dram)
    for m in ("STT", "SOT"):
        assert energy.relative(base, energy.evaluate(p, cfgs[m])) == \
            jenergy.relative(jbase, jenergy.evaluate(p, cfgs[m]))
    r = np.array([1e6, 3e7, 5.5e5], np.float32)
    w = np.array([2e5, 1e6, 9e4], np.float32)
    d = np.array([1e4, 3e4, 2e3], np.float32)
    ppa = energy.ppa_scalars(cfgs["STT"])
    mine = energy.evaluate_arrays(*(torch.from_numpy(x) for x in (r, w, d)),
                                  ppa, leak_scale=0.5)
    ref = jenergy.evaluate_arrays(*(jnp.asarray(x) for x in (r, w, d)),
                                  ppa, leak_scale=0.5)
    for k in ref:
        _close(mine[k].numpy(), ref[k])


def _same_results(mine, ref, rel=REL):
    assert [r.workload for r in mine] == [r.workload for r in ref]
    for a, b in zip(mine, ref):
        for m in iso.NVM_MEMS:
            assert a.metrics[m].keys() == b.metrics[m].keys()
            for k in b.metrics[m]:
                assert a.metrics[m][k] == pytest.approx(b.metrics[m][k],
                                                        rel=rel), (m, k)


def test_iso_capacity_and_area_match_jax():
    _same_results(iso.iso_capacity(device=CPU), jiso.iso_capacity())
    mine = iso.iso_area(device=CPU)
    ref = jiso.iso_area()
    _same_results(mine, ref)
    for metric in ("edp", "edp_with_dram"):
        s, js = iso.summarize(mine, metric), jiso.summarize(ref, metric)
        for m in iso.NVM_MEMS:
            for k in js[m]:
                assert s[m][k] == pytest.approx(js[m][k], rel=REL)
    assert iso.iso_area_capacities(device=CPU) == jiso.iso_area_capacities()
    with pytest.raises(ValueError, match="dram_model"):
        iso.iso_area(dram_model="oracle", device=CPU)


def test_iso_area_trace_model_matches_jax():
    """``dram_model="trace"``: the port's plain LRU against the Pallas
    ladder kernel (interpret mode), trace_kwargs forwarded."""
    kw = {"trace_len": 3000, "scale": 256}
    _same_results(iso.iso_area(dram_model="trace", trace_kwargs=kw,
                               device=CPU),
                  jiso.iso_area(dram_model="trace", trace_kwargs=kw))


@pytest.mark.parametrize("mode", ["training", "inference"])
def test_batch_sweep_matches_jax(mode):
    mine = iso.batch_sweep("AlexNet", mode, device=CPU)
    ref = jiso.batch_sweep("AlexNet", mode)
    assert list(mine) == list(ref)
    _same_results(list(mine.values()), list(ref.values()))


def test_scaling_matches_jax():
    mine, ref = scaling.ppa_scaling(device=CPU), jscaling.ppa_scaling()
    for m in ref:
        for c in ref[m]:
            _same_ppa(mine[m][c], ref[m][c])
    for mode in (None, "training"):
        ws = scaling.workload_scaling(mode_filter=mode, device=CPU)
        jws = jscaling.workload_scaling(mode_filter=mode)
        assert ws.keys() == jws.keys()
        for c in jws:
            for m in jws[c]:
                for k in jws[c][m]:
                    for s in ("mean", "min"):
                        assert ws[c][m][k][s] == pytest.approx(
                            jws[c][m][k][s], rel=REL)
                    # a spread of nearly equal ratios: its absolute error
                    # is the mean's rounding, not a relative one of its own
                    assert ws[c][m][k]["std"] == pytest.approx(
                        jws[c][m][k]["std"], rel=1e-4,
                        abs=REL * jws[c][m][k]["mean"])


# --- the slice as a whole, and the device rules ---------------------------------


def test_quickstart_equals_the_jax_quickstart():
    """The port's quickstart prints, line for line, what the JAX package's
    ``examples/quickstart.py`` prints."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        quickstart.main(["--device", "cpu"])
    jbuf = io.StringIO()
    src = (ROOT / "examples" / "quickstart.py").read_text()
    with redirect_stdout(jbuf):
        exec(compile(src, "quickstart.py", "exec"), {"__name__": "qs"})
    assert buf.getvalue() == jbuf.getvalue()
    res = quickstart.run(CPU)
    jcfgs = {m: jtuner.tune(m, 3) for m in jbitcell.TABLE1}
    for m in jcfgs:
        _same_ppa(res["cfgs"][m], jcfgs[m])
    assert res["iso_area"] == jiso.iso_area_capacities()


def test_entry_points_default_to_cuda(monkeypatch):
    """With no device given, an entry point asks for CUDA and raises where
    there is none; it never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tuner.tune("SRAM", 3),
                 lambda: sweep.sweep(("SRAM",), (3.0,)),
                 lambda: profiles.paper_profiles(),
                 lambda: iso.iso_area_capacities(),
                 lambda: cachesim.simulate_ladder(np.arange(8), (1.0,)),
                 lambda: cachesim.simulate_reference(np.arange(8), 16),
                 lambda: quickstart.run()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_caches_key_on_the_device():
    """A cached result is served again only for the device it was
    computed on ("cpu" and "cpu:0" are two keys)."""
    for fn, cached in ((lambda d: tuner.tune("SOT", 3, device=d),
                        tuner._tune_cached),
                       (lambda d: profiles.paper_profiles(device=d),
                        profiles._paper_profiles_cached)):
        cached.cache_clear()
        fn("cpu")
        fn("cpu")
        fn("cpu:0")
        info = cached.cache_info()
        assert (info.hits, info.currsize) == (1, 2)
