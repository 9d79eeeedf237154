"""The port's NVM verdicts on its own traffic against the JAX package, on
the CPU: ``core/crosslayer.py`` against ``repro.core.crosslayer`` on the
same records (rel 1e-6), ``launch/roofline.py`` against
``repro.launch.roofline`` (``model_flops`` exactly), the op counter of
``launch/graph_analysis.py`` on unit cases and at every kernel boundary,
and the engines' and the train window's records against the JAX engines'
on the same weights and requests.

The JAX engines count their compiled programs' HLO; the port counts its
own op graph.  On the records compared here the two agree on flops within
5% once the one structural difference is stated: the JAX prefill
unembeds every one of its P positions, where the port's prefill unembeds
each row's last prompt position only (``logits_at``); the tests add those
2 x slots x (P - 1) x d x V products to the port's count.  The train
record runs at seq 512, one key block of the JAX chunked attention, which
pads keys to its 512-key block at shorter sequences.  Bytes are compared
after the walker's data moves are taken from the JAX count: on XLA:CPU
the walker counts the per-layer weight and state slices that the layer
scan materialises and the loop's buffer copies (``copy``, ``transpose``,
``slice``, ``dynamic-slice`` and fusions of nothing else; 6-51% of its
bytes here), and the port, whose slices are views, makes none of them.
The rest is held to a band pinned per record kind (``BYTE_BANDS``, all
inside 0.5x-4x).  The serve records are memory bound at the modeled
tier, where the energy and EDP ratios depend only on the read split, so
the port's serve verdicts equal the JAX engine's within rel 1e-4
whatever the bytes.
"""
import contextlib
import io
import json
import re
import zlib
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import reduced as jreduced
from repro.core import crosslayer as jcl
from repro.data import DataConfig as JDataConfig
from repro.launch import hlo_analysis as jha
from repro.launch import roofline as jrf
from repro.models import build_model as jbuild_model
from repro.optim import AdamW as JAdamW
from repro.optim import constant as jconstant
from repro.serve import Engine as JEngine
from repro.serve import PagedEngine as JPagedEngine
from repro.serve import Request as JRequest
from repro.train.trainer import init_state as jinit_state
from repro.train.trainer import make_train_window as jmake_train_window
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.core import crosslayer as cl
from repro_torch.data import DataConfig
from repro_torch.examples import nvm_sweep
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import sampling as sm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import graph_analysis as ga
from repro_torch.launch import roofline as rf
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import AdamW, constant
from repro_torch.serve import (Engine, PagedEngine, Request, run_staggered,
                               shared_prefix_requests, staggered_groups)
from repro_torch.train.trainer import init_state, make_train_window

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-6
SLOTS, MAX_LEN, K, P = 3, 32, 2, 8
# port bytes / (JAX bytes - the walker's data moves, ``_walker_moves``)
# per (family, record kind), as measured at the sizes below (PERF.md §6)
BYTE_BANDS = {("dense", "decode"): (0.56, 0.63),
              ("dense", "prefill"): (0.94, 1.05),
              ("paged", "decode"): (0.52, 0.58),
              ("paged", "prefill"): (0.70, 1.15),
              ("ssm", "decode"): (0.70, 0.77),
              ("ssm", "prefill"): (0.81, 0.90),
              ("hybrid", "decode"): (0.94, 1.04),
              ("hybrid", "prefill"): (1.14, 1.27),
              ("dense", "train"): (0.81, 0.90),
              ("ssm", "train"): (0.94, 1.04),
              ("moe", "train"): (0.88, 0.97),
              ("moe", "decode"): (0.93, 1.03),
              ("moe", "prefill"): (1.06, 1.17),
              ("paged moe", "decode"): (0.91, 1.01),
              ("paged moe", "prefill"): (0.96, 1.25)}


def _close(a, b, rel=REL):
    assert a == pytest.approx(b, rel=rel, abs=0.0), (a, b)


def _same_verdicts(got, want, rel=REL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.arch, g.shape, g.mesh) == (w.arch, w.shape, w.mesh)
        for f in ("reads", "writes", "step_s"):
            _close(getattr(g, f), getattr(w, f), rel)
        for m in ("STT", "SOT"):
            _close(g.energy_ratio[m], w.energy_ratio[m], rel)
            _close(g.edp_ratio[m], w.edp_ratio[m], rel)


def _rec(shape="serve_decode", kind="decode", **extra):
    rng = np.random.default_rng(zlib.crc32(shape.encode()))
    roof = {"flops_per_device": float(rng.uniform(1e9, 1e12)),
            "bytes_per_device": float(rng.uniform(1e7, 1e10)),
            "collective_bytes": 0.0,
            "compute_s": float(rng.uniform(1e-5, 1e-2)),
            "memory_s": float(rng.uniform(1e-5, 1e-2)),
            "collective_s": float(rng.uniform(0.0, 1e-3))}
    return {"arch": "x", "mesh": "1dev", "kind": kind, "shape": shape,
            "roofline": roof, **extra}


# --- core/crosslayer.py against repro.core.crosslayer -----------------------


def test_constants_match_jax():
    for name in ("READ_FRACTION", "TRAIN_READ_FRACTION",
                 "RECURRENT_READ_FRACTION", "SRAM_LEAK_DERATE"):
        assert getattr(cl, name) == getattr(jcl, name)


def test_crosslayer_verdict():
    """Mirror of ``tests/test_sharding_roofline.py::test_crosslayer_verdict``
    on the port, and equal to the JAX verdict."""
    rec = {"arch": "x", "shape": "train_4k", "mesh": "16x16",
           "roofline": {"bytes_per_device": 1e12, "compute_s": 1.0,
                        "memory_s": 1.2, "collective_s": 0.3}}
    v = cl.analyze_record(rec, device="cpu")
    assert v.reads > v.writes > 0
    for m in ("STT", "SOT"):
        assert 0 < v.energy_ratio[m] < 10
        assert 0 < v.edp_ratio[m] < 10
    _same_verdicts([v], [jcl.analyze_record(rec)])


@pytest.mark.parametrize("tier_mb", [None, 32.0])
@pytest.mark.parametrize("read_fraction", [None, 0.7, "per-record"])
def test_analyze_records_matches_jax(tier_mb, read_fraction):
    recs = [_rec(f"s{i}") for i in range(5)]
    kw = {} if tier_mb is None else {"tier_mb": tier_mb}
    jkw = dict(kw)
    if read_fraction == "per-record":
        rfs = [0.3, 0.45, 0.5, 0.6, 0.9]
        kw["read_fraction"] = rfs
        jkw["read_fraction"] = jax.numpy.asarray(rfs, jax.numpy.float32)
    elif read_fraction is not None:
        kw["read_fraction"] = jkw["read_fraction"] = read_fraction
    _same_verdicts(cl.analyze_records(recs, device="cpu", **kw),
                   jcl.analyze_records(recs, **jkw))
    assert cl.analyze_records([]) == []


def test_analyze_serve_scales_and_splits_like_jax():
    recs = [_rec("a"), _rec("b", unique_page_fraction=0.37),
            _rec("c", read_fraction=cl.RECURRENT_READ_FRACTION),
            _rec("d", unique_page_fraction=1.0, read_fraction=0.2)]
    _same_verdicts(cl.analyze_serve(recs, device="cpu"),
                   jcl.analyze_serve(recs))
    _same_verdicts(cl.analyze_serve(recs, tier_mb=64, device="cpu"),
                   jcl.analyze_serve(recs, tier_mb=64))


def test_analyze_train_matches_jax():
    recs = [_rec("t0", "train"), _rec("t1", "train")]
    _same_verdicts(cl.analyze_train(recs, device="cpu"),
                   jcl.analyze_train(recs))


@pytest.mark.parametrize("fn", ["analyze_records", "analyze_record",
                                "analyze_serve", "analyze_train"])
def test_crosslayer_runs_on_cuda_unless_asked_for_the_cpu(fn, monkeypatch):
    """As every core function, the verdicts run on CUDA by default and
    refuse, rather than fall back to the CPU, where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arg = _rec() if fn == "analyze_record" else [_rec()]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(cl, fn)(arg)
    assert getattr(cl, fn)(arg, device="cpu")


def _message(fn, *args, **kw):
    with pytest.raises((ValueError, FileNotFoundError)) as e:
        fn(*args, **kw)
    return type(e.value), str(e.value)


@pytest.mark.parametrize("case", [
    ("serve", [{"arch": "x", "shape": "serve_decode", "mesh": "1dev",
                "roofline": {"bytes_per_device": 1.0}}]),
    ("serve", [_rec(unique_page_fraction=0.0)]),
    ("serve", [_rec(unique_page_fraction=1.5)]),
    ("serve", [_rec(read_fraction=1.0)]),
    ("train", [{"arch": "x", "mesh": "1dev", "shape": "t",
                "roofline": {"bytes_per_device": 1.0}}]),
])
def test_errors_match_jax(case):
    """Mirror of ``test_analyze_serve_rejects_termless_records``,
    ``test_unique_page_fraction_scales_verdict_traffic``'s refusal and
    ``test_analyze_train_missing_roofline_raises``: the same exception and
    message as the JAX package."""
    mode, recs = case
    fn, jfn = ((cl.analyze_serve, jcl.analyze_serve) if mode == "serve"
               else (cl.analyze_train, jcl.analyze_train))
    assert _message(fn, recs) == _message(jfn, recs)
    assert fn([]) == []


def test_unique_page_fraction_scales_verdict_traffic():
    """Mirror of ``tests/test_paged_cache.py``'s test of that name."""
    full = cl.analyze_serve([_rec()], device="cpu")[0]
    half = cl.analyze_serve([_rec(unique_page_fraction=0.5)],
                            device="cpu")[0]
    assert half.reads == pytest.approx(full.reads * 0.5)
    assert half.writes == pytest.approx(full.writes * 0.5)
    assert half.step_s <= full.step_s


def test_analyze_train_uses_write_heavier_split():
    """Mirror of ``tests/test_train_engine.py``'s test of that name."""
    assert cl.TRAIN_READ_FRACTION < cl.READ_FRACTION
    rec = {"arch": "x", "mesh": "1dev", "shape": "t", "kind": "train",
           "roofline": {"flops_per_device": 1e12, "bytes_per_device": 1e9,
                        "collective_bytes": 0.0, "compute_s": 1e-3,
                        "memory_s": 2e-3, "collective_s": 0.0}}
    t = cl.analyze_train([rec], device="cpu")[0]
    s = cl.analyze_serve([rec], device="cpu")[0]
    assert t.writes > s.writes and t.reads < s.reads
    assert t.reads / (t.reads + t.writes) == pytest.approx(
        cl.TRAIN_READ_FRACTION)
    for mem in ("STT", "SOT"):
        assert t.energy_ratio[mem] < s.energy_ratio[mem]


def test_analyze_dryrun_dir_matches_jax(tmp_path):
    """``*__tag.json`` records of a results dir, and the missing-dir and
    missing-tag refusals (mirror of
    ``tests/test_traffic_engine.py::test_analyze_dryrun_dir_missing_raises``),
    as in the JAX package."""
    for i in range(3):
        (tmp_path / f"cell{i}__baseline.json").write_text(
            json.dumps(_rec(f"cell{i}")))
    (tmp_path / "other__final.json").write_text(json.dumps(_rec("o")))
    _same_verdicts(cl.analyze_dryrun_dir(str(tmp_path), device="cpu"),
                   jcl.analyze_dryrun_dir(str(tmp_path)))
    _same_verdicts(cl.analyze_dryrun_dir(str(tmp_path), tag="final",
                                         device="cpu"),
                   jcl.analyze_dryrun_dir(str(tmp_path), tag="final"))
    missing = tmp_path / "nope"
    got = _message(cl.analyze_dryrun_dir, str(missing))
    assert got == _message(jcl.analyze_dryrun_dir, str(missing))
    assert "nope" in got[1]
    empty = tmp_path / "empty"
    empty.mkdir()
    got = _message(cl.analyze_dryrun_dir, str(empty), tag="mytag")
    assert got == _message(jcl.analyze_dryrun_dir, str(empty), tag="mytag")
    assert "mytag" in got[1]


# --- launch/roofline.py against repro.launch.roofline -----------------------


def test_roofline_terms_match_jax():
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.ICI_BW) == (
        jrf.PEAK_FLOPS, jrf.HBM_BW, jrf.ICI_BW)
    for flops, nbytes, coll in ((1e12, 1e9, 0.0), (1e9, 4e11, 1e8),
                                (0.0, 0.0, 0.0), (3e14, 1e8, 2e11)):
        r = rf.Roofline(flops, nbytes, collective_bytes=coll)
        j = jrf.Roofline(flops, nbytes, coll, {}, {}, 0.0, 0.0)
        for name in ("compute_s", "memory_s", "collective_s", "dominant",
                     "bound_s"):
            assert getattr(r, name) == getattr(j, name)
        assert r.model_flops_util(5e11) == j.model_flops_util(5e11)
        rd, jd = r.to_dict(), j.to_dict()
        for key in ("flops_per_device", "bytes_per_device",
                    "collective_bytes", "compute_s", "memory_s",
                    "collective_s", "dominant"):
            assert rd[key] == jd[key]


def test_model_flops_equals_jax_exactly():
    for arch in jlist_archs():
        for name, shape in SHAPES.items():
            for chips in (1, 4, 256):
                assert rf.model_flops(get_config(arch), shape, chips) == \
                    jrf.model_flops(jget_config(arch), JSHAPES[name], chips)


def test_dtype_bytes_matches_jax():
    for name in ("bf16", "float32", "int32", "s8", "f8e4m3fn"):
        assert rf.dtype_bytes(name) == jrf.dtype_bytes(name)


def test_from_stats_carries_the_count():
    st = ga.OpStats()
    st.add("mm", 2e9, 3e6)
    st.add("decode_attention", 1e6, 5e5)
    st.kernel_calls["decode_attention"] = 1
    r = rf.Roofline.from_stats(st)
    assert (r.flops_per_device, r.bytes_per_device) == (2.001e9, 3.5e6)
    assert r.collective_bytes == 0.0 and r.collective_s == 0.0
    assert r.kernel_calls == {"decode_attention": 1}
    assert r.to_dict()["bytes_by_op"] == {"mm": 3e6,
                                          "decode_attention": 5e5}


# --- launch/graph_analysis.py: the counter ----------------------------------


def _count(fn, *args, **kw):
    with ga.OpCounter() as c:
        fn(*args, **kw)
    return c.stats


def test_mm_counts_2mnk():
    a, b = torch.randn(5, 7), torch.randn(7, 3)
    st = _count(torch.mm, a, b)
    assert st.flops == 2 * 5 * 3 * 7
    assert st.bytes == 4 * (5 * 7 + 7 * 3 + 5 * 3)
    x, w = torch.randn(2, 5, 7), torch.randn(7, 3)
    assert _count(lambda: x @ w).flops == 2 * 10 * 3 * 7
    bias = torch.randn(3)
    assert _count(torch.addmm, bias, a, b).flops == 2 * 5 * 3 * 7
    assert _count(torch.bmm, x, torch.randn(2, 7, 4)).flops == \
        2 * 2 * 5 * 4 * 7


def test_view_chain_counts_nothing():
    x = torch.randn(4, 6, 8)
    st = _count(lambda: x.view(24, 8).t().reshape(8, 4, 6)
                .permute(2, 0, 1)[1:3, :, 0].unsqueeze(0).expand(3, 2, 8)
                .squeeze(0).detach())
    assert (st.flops, st.bytes) == (0.0, 0.0)
    assert _count(torch.empty, 1000).bytes == 0.0


def test_row_write_counts_the_row_not_the_cache():
    B, L, Kh, hd = 4, 64, 2, 16
    cache = torch.zeros(B, L, Kh, hd)
    row = torch.randn(1, Kh, hd)
    rows = torch.tensor([2])
    pos = torch.tensor([17])

    def write():
        cache[rows, pos] = row
    st = _count(write)
    assert st.bytes == 2 * row.numel() * 4
    st = _count(lambda: cache.index_copy_(0, rows, torch.ones(1, L, Kh, hd)))
    assert st.bytes_by_op["index_copy_"] == 2 * L * Kh * hd * 4
    st = _count(lambda: cache[1, :5].copy_(torch.ones(5, Kh, hd)))
    assert st.bytes_by_op["copy_"] == 2 * 5 * Kh * hd * 4


def test_other_ops_count_operands_by_their_own_size():
    big = torch.randn(100, 32)
    st = _count(lambda: big[:10] * 2.0)        # a view operand: 10 rows
    assert st.bytes == 2 * 10 * 32 * 4
    a = torch.randn(8)
    st = _count(lambda: a + a)                  # one distinct operand
    assert st.bytes == 2 * 8 * 4


def _kernel_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)
    B, H, Kh, hd, L = 3, 4, 2, 16, 20
    q, k, v = r(B, H, hd), r(B, L, Kh, hd), r(B, L, Kh, hd)
    nk, nv = r(B, Kh, hd), r(B, Kh, hd)
    pos = torch.tensor([3, 7, 19], dtype=torch.int32)
    ps, nb = 4, 5
    pool_k, pool_v = r(16, ps, Kh, hd), r(16, ps, Kh, hd)
    pt = torch.arange(B * nb, dtype=torch.int32).reshape(B, nb)
    lg, temps = r(B, 50), torch.tensor([0.0, 0.7, 1.0])
    key = torch.tensor([1, 2], dtype=torch.int64)
    x, dt = r(2, 16, 3, 8), torch.rand(2, 16, 3, generator=g)
    dtA, Bm, Cm = -torch.rand(2, 16, 3, generator=g), r(2, 16, 6), r(2, 16, 6)
    s0 = r(2, 3, 8, 6)
    a, b, h0 = torch.rand(2, 9, 12, generator=g), r(2, 9, 12), r(2, 12)
    xr, rr, ir, lam = r(2, 9, 12), torch.rand(2, 9, 12, generator=g), \
        torch.rand(2, 9, 12, generator=g), r(12)
    fq, fk, fv = r(2, 4, 10, 16), r(2, 2, 12, 16), r(2, 2, 12, 16)
    return {
        "decode_attention": (ops.decode_attention, (q, k, v, pos),
                             da.decode_attention_plain),
        "decode_attention_fused": (
            ops.decode_attention_fused, (q, k, v, nk, nv, pos),
            da.decode_attention_fused_plain),
        "paged_decode_attention": (
            ops.paged_decode_attention, (q, pool_k, pool_v, pt, pos),
            pa.paged_decode_attention_plain),
        "paged_decode_attention_fused": (
            ops.paged_decode_attention_fused,
            (q, pool_k, pool_v, nk, nv, pt, pos),
            pa.paged_decode_attention_fused_plain),
        "fused_sample": (ops.fused_sample, (lg, temps, key),
                         sm.fused_sample_plain),
        "ssd_scan": (lambda *t: ops.ssd_scan(*t, chunk=8),
                     (x, dt, dtA, Bm, Cm),
                     lambda *t: ssd.ssd_scan_plain(*t, chunk=8)),
        "ssd_scan_s0": (lambda *t: ops.ssd_scan(*t[:5], chunk=4, s0=t[5]),
                        (x, dt, dtA, Bm, Cm, s0),
                        lambda *t: ssd.ssd_scan_plain(*t[:5], chunk=4,
                                                      s0=t[5])),
        "rglru_scan": (ops.rglru_scan, (a, b, h0), rg.rglru_scan_plain),
        "rglru_gated_scan": (ops.rglru_gated_scan, (xr, rr, ir, lam, h0),
                             rg.rglru_gated_scan_plain),
        "flash_attention": (lambda *t: ops.flash_attention(*t,
                                                           causal=False),
                            (fq, fk, fv),
                            lambda *t: fa.flash_attention_plain(
                                *t, causal=False)),
    }


@pytest.mark.parametrize("name", sorted(_kernel_cases()))
def test_kernel_boundary_declares_its_plain_versions_flops(name):
    """Each wrapper's declared flops equal the products its plain version
    performs on the same inputs (so the formulas cannot drift); inside
    the boundary nothing else is counted; the wrapper's result is the
    plain version's."""
    wrapper, args, plain = _kernel_cases()[name]
    clone = lambda: [t.clone() for t in args]   # noqa: E731 (fused: in place)
    plain_stats = _count(plain, *clone())
    inputs = clone()
    with ga.OpCounter() as c:
        got = wrapper(*inputs)
    kernel = ("rglru_scan" if name.startswith("rglru")
              else name.replace("_fused", "").replace("_s0", ""))
    assert c.stats.kernel_calls == {kernel: 1}
    assert c.stats.flops == plain_stats.flops
    assert c.stats.bytes_by_op == {kernel: c.stats.bytes} and \
        c.stats.bytes > 0
    want = plain(*clone())
    for g_, w_ in zip(got if isinstance(got, tuple) else (got,),
                      want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g_, w_)


def test_boundary_outside_a_counter_counts_nothing():
    assert ga.active_counter() is None
    with ga.kernel("x", lambda: 1 / 0):     # traffic is never asked for
        pass
    with ga.OpCounter() as c:
        assert ga.active_counter() is c
    assert ga.active_counter() is None


def _body(a, b):
    a @ b
    (a + 1).sum()
    with ga.kernel("k", lambda: (7.0, 11.0)):
        a @ b                                   # paused: not counted


@pytest.mark.parametrize("n", [1, 5])
def test_loop_counts_its_first_iteration_n_times(n):
    """A loop counted by its first iteration counts what counting every
    iteration counts, kernel calls included; outside a counter it counts
    nothing."""
    a, b = torch.ones(4, 3), torch.ones(3, 5)
    with ga.OpCounter() as each:
        for _ in range(n):
            _body(a, b)
    with ga.OpCounter() as first:
        a @ b                                   # outside the loop
        step = ga.loop(n)
        for _ in range(n):
            with step():
                _body(a, b)
    want = ga.OpStats()
    want.merge(each.stats)
    want.add("mm", 2.0 * 4 * 5 * 3, (12 + 15 + 20) * 4)
    assert first.stats == want
    assert first.stats.kernel_calls == {"k": n}
    step = ga.loop(n)
    for _ in range(n):
        with step():
            _body(a, b)


def test_uncounted_iterations_and_kernels_leave_the_dispatch_stack():
    """A loop's later iterations and a kernel's call run with the counter
    off the dispatch-mode stack: their ops do not pass through it."""
    seen = []
    with ga.OpCounter() as c:
        step = ga.loop(3)
        for _ in range(3):
            with step():
                seen.append(ga.active_counter())
                with ga.kernel("k", lambda: (0.0, 0.0)):
                    seen.append(ga.active_counter())
        assert ga.active_counter() is c
    assert seen == [c, None, None, None, None, None]


@pytest.mark.parametrize("arch,paged", [("llama3-8b", False),
                                        ("llama3-8b", True),
                                        ("mamba2-1.3b", False),
                                        ("recurrentgemma-2b", False),
                                        ("granite-moe-3b-a800m", False),
                                        ("granite-moe-3b-a800m", True)])
def test_engine_counts_a_window_and_a_scan_by_their_first_step(
        arch, paged, monkeypatch):
    """The decode window's ticks and the recurrent prefill scan's steps run
    the same ops on the same shapes, so counting the first of them equals
    counting every one (``graph_analysis.loop`` against a loop that counts
    each iteration), record for record."""
    _, _, model, params = _models(arch)
    stats = []
    for each in (False, True):
        if each:
            monkeypatch.setattr(ga, "loop", lambda n: contextlib.nullcontext)
        E = PagedEngine if paged else Engine
        eng = E(model, params, slots=2, max_len=MAX_LEN, ticks_per_sync=3,
                device="cpu")
        reqs = [Request(uid=i, prompt=list(range(1 + i, 6 + 3 * i)),
                        max_new_tokens=5) for i in range(4)]
        run_staggered(eng, staggered_groups(reqs, 2))
        stats.append(eng._traffic)
    assert stats[0]["decode"] is not None and stats[0]["prefill"]
    assert stats[0] == stats[1]


# --- the engines' records against the JAX engines' --------------------------


def _models(arch):
    jcfg = jreduced(jget_config(arch), dtype="float32")
    jmodel = jbuild_model(jcfg, max_seq=MAX_LEN)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = reduced(get_config(arch), dtype="float32")
    model = build_model(cfg, max_seq=MAX_LEN, device="cpu")
    params = params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in jparams.items()}, device="cpu")
    return jmodel, jparams, model, params


def _full_waves(paged: bool):
    """Prompts for two waves of a full set of slots, every prompt's
    (unshared) length at a power of two, so that the JAX prefill program
    (all slots at the padded length) and the port's (the admitted rows)
    do the same work.  The paged waves share one 24-token template."""
    rng = np.random.default_rng(5)
    if not paged:
        return [[rng.integers(1, 500, P).tolist() for _ in range(SLOTS)]
                for _ in range(2)]
    tpl = rng.integers(1, 500, 24).tolist()
    return [[tpl + rng.integers(1, 500, 2).tolist() for _ in range(SLOTS)]
            for _ in range(2)]


def _serve(eng, req_cls, waves):
    outs = {}
    for w, prompts in enumerate(waves):
        reqs = [req_cls(uid=w * SLOTS + i, prompt=p, max_new_tokens=2 * K)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        outs.update({r.uid: list(r.output) for r in reqs})
    return outs


@pytest.fixture
def walker_texts(monkeypatch):
    """The optimized HLO text of every program the JAX engines analyse,
    keyed by the id of the ``Roofline`` it gave."""
    texts = {}
    analyze = jrf.analyze

    def keep(compiled):
        rl = analyze(compiled)
        texts[id(rl)] = compiled.as_text()
        return rl

    monkeypatch.setattr(jrf, "analyze", keep)
    return texts


# ops that only move data: what a layer scan's slices and a loop's
# buffer copies lower to on XLA:CPU
_MOVES = frozenset(("parameter", "constant", "bitcast", "reshape", "copy",
                    "transpose", "slice", "dynamic-slice"))


def _walker_moves(text: str) -> float:
    """The bytes the JAX walker (``analyze_hlo``) counts for instructions
    that only move data: ``copy``, ``transpose``, ``slice`` and
    ``dynamic-slice`` instructions and fusions made of nothing else (the
    per-layer weight and state slices that the layer scan materialises,
    the loop's buffer copies).  The port's slices and permutes are views,
    so it has none of them.  Each instruction's bytes are the walker's
    own: every instruction is tagged and the walker's per-instruction
    tally read back."""
    moved = [0.0]
    parse, add = jha.parse_hlo, jha.HloStats._add_scope

    def tagged(t):
        comps, entry = parse(t)
        for comp in comps.values():
            for ins in comp.instrs:
                ops = {ins.op}
                if ins.op == "fusion":
                    name = re.search(r"calls=%([\w.\-]+)", ins.attrs).group(1)
                    ops = {i.op for i in comps[name].instrs}
                ins.attrs += " moves" if ops <= _MOVES else " computes"
        return comps, entry

    def tally(self, attrs, nbytes, nflops=0.0):
        if attrs.endswith(" moves"):
            moved[0] += nbytes
        return add(self, attrs, nbytes, nflops)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jha, "parse_hlo", tagged)
        mp.setattr(jha.HloStats, "_add_scope", tally)
        total = jha.analyze_hlo(text).bytes
    assert 0.0 < moved[0] < total
    return moved[0]


def _byte_ratio(label, port_bytes, jax_bytes, jax_moves):
    """port / (JAX - the walker's data moves), held to its pinned band; the
    breakdown is printed (``pytest -s``)."""
    ratio = port_bytes / (jax_bytes - jax_moves)
    print(f"bytes {label}: port {port_bytes:.6e}, JAX {jax_bytes:.6e} of "
          f"which data moves {jax_moves / jax_bytes:.4f}; port / JAX "
          f"{port_bytes / jax_bytes:.4f}, port / (JAX - moves) {ratio:.4f}")
    return ratio


def test_byte_bands_lie_within_half_to_four():
    for lo, hi in BYTE_BANDS.values():
        assert 0.5 <= lo < hi <= 4.0


def _unembed_rows(cfg, rec):
    """Products of the JAX prefill's unembedding of the P - 1 positions
    per slot that the port's ``logits_at`` prefill does not unembed."""
    if cfg.family not in ("dense", "moe") or rec["kind"] != "prefill":
        return 0.0
    P_ = int(re.search(r"_p(\d+)_", rec["shape"]).group(1))
    return 2.0 * SLOTS * (P_ - 1) * cfg.d_model * cfg.vocab_size


@pytest.mark.parametrize("arch,paged", [("llama3-8b", False),
                                        ("llama3-8b", True),
                                        ("mamba2-1.3b", False),
                                        ("recurrentgemma-2b", False),
                                        ("granite-moe-3b-a800m", False),
                                        ("granite-moe-3b-a800m", True)])
def test_serve_records_match_jax(arch, paged, walker_texts):
    jmodel, jparams, model, params = _models(arch)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, ticks_per_sync=K)
    if paged:
        jeng = JPagedEngine(jmodel, jparams, page_size=4, **kw)
        eng = PagedEngine(model, params, page_size=4, device="cpu", **kw)
    else:
        jeng = JEngine(jmodel, jparams, **kw)
        eng = Engine(model, params, device="cpu", **kw)
    waves = _full_waves(paged)
    assert _serve(eng, Request, waves) == _serve(jeng, JRequest, waves)
    recs, jrecs = eng.serve_records(), jeng.serve_records()
    assert [r["shape"] for r in recs] == [r["shape"] for r in jrecs]
    assert len(recs) >= 2
    fam = model.cfg.family
    if paged:
        fam = "paged" if fam == "dense" else f"paged {fam}"
    for r, j in zip(recs, jrecs):
        for key in ("arch", "mesh", "kind", "family", "ticks", "calls",
                    "read_fraction"):
            assert r.get(key) == j.get(key), key
        rr, jr = r["roofline"], j["roofline"]
        flops = rr["flops_per_device"] + _unembed_rows(model.cfg, r)
        assert flops == pytest.approx(jr["flops_per_device"], rel=0.05)
        if r["kind"] == "decode":
            prog, per = jeng._traffic["decode"], K
        else:
            P_ = int(re.search(r"_p(\d+)_", r["shape"]).group(1))
            prog, per = jeng._traffic["prefill"][P_], 1
        moves = _walker_moves(walker_texts[id(prog)]) / per
        lo, hi = BYTE_BANDS[(fam, r["kind"])]
        assert lo <= _byte_ratio(r["shape"], rr["bytes_per_device"],
                                 jr["bytes_per_device"], moves) <= hi
        assert rr["memory_s"] > rr["compute_s"]       # memory bound
        assert jr["memory_s"] > jr["compute_s"]
    if paged:
        dec = next(r for r in recs if r["kind"] == "decode")
        jdec = next(r for r in jrecs if r["kind"] == "decode")
        assert dec["unique_page_fraction"] == jdec["unique_page_fraction"]
        assert 0.0 < dec["unique_page_fraction"] < 1.0
    got, want = eng.nvm_verdicts(), jeng.nvm_verdicts()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        for m in ("STT", "SOT"):
            _close(g.energy_ratio[m], w.energy_ratio[m], 1e-4)
            _close(g.edp_ratio[m], w.edp_ratio[m], 1e-4)


def test_serve_records_and_nvm_verdicts():
    """Mirror of ``tests/test_serve_engine.py``'s test of that name: one
    decode record (per tick, ``ticks`` = the decode ticks run) and one
    prefill record per padded length; the first window is counted once,
    the count is kept across ``reset``."""
    _, _, model, params = _models("llama3-8b")
    eng = Engine(model, params, slots=2, max_len=16, ticks_per_sync=2,
                 device="cpu")
    eng.submit(Request(uid=0, prompt=[1, 2, 3], max_new_tokens=4))
    eng.submit(Request(uid=1, prompt=[4, 5], max_new_tokens=3))
    eng.run()
    recs = eng.serve_records()
    assert {r["kind"] for r in recs} == {"decode", "prefill"}
    for r in recs:
        assert r["roofline"]["bytes_per_device"] > 0
        assert r["roofline"]["memory_s"] > 0
        assert r["mesh"] == "1dev"
    decode = next(r for r in recs if r["kind"] == "decode")
    assert decode["attn_impl"] == "kernel"
    assert decode["ticks"] == eng.counts["decode_ticks"] > 0
    assert eng._traffic["decode"].kernel_calls == {
        "decode_attention": model.cfg.num_layers * 2, "fused_sample": 2}
    verdicts = eng.nvm_verdicts()
    assert len(verdicts) == len(recs)
    for v in verdicts:
        assert set(v.energy_ratio) == {"STT", "SOT"}
        assert v.edp_ratio["SOT"] > 0
    counted = eng._traffic["decode"]
    eng.reset()
    assert eng._traffic["decode"] is counted
    assert eng.serve_records() == []          # no tick run since reset


def test_paged_serve_records_carry_measured_fraction():
    """Mirror of ``tests/test_paged_cache.py``'s test of that name."""
    _, _, model, params = _models("llama3-8b")
    eng = PagedEngine(model, params, slots=3, max_len=48, page_size=4,
                      eos_id=7, ticks_per_sync=2, device="cpu")
    reqs = shared_prefix_requests(6, seed=3, vocab=512, num_templates=1,
                                  template_len=26, suffix_lens=(2, 5),
                                  max_new=(3, 6))
    run_staggered(eng, staggered_groups(reqs, 3))
    dec = [r for r in eng.serve_records() if r["kind"] == "decode"]
    assert dec and 0.0 < dec[0]["unique_page_fraction"] < 1.0
    verdicts = eng.nvm_verdicts()
    assert verdicts and all(v.reads > 0 for v in verdicts)


@pytest.mark.parametrize("arch,paged", [("llama3-8b", False),
                                        ("llama3-8b", True),
                                        ("recurrentgemma-2b", False)])
def test_recording_changes_no_token(arch, paged):
    """Tokens with ``record_traffic=True`` equal those with ``False``
    bitwise (temperature rows included); ``False`` gives no records and
    no verdicts."""
    _, _, model, params = _models(arch)
    outs = {}
    for record in (True, False):
        E = PagedEngine if paged else Engine
        eng = E(model, params, slots=2, max_len=MAX_LEN, ticks_per_sync=3,
                record_traffic=record, device="cpu")
        reqs = [Request(uid=i, prompt=list(range(1 + i, 6 + 2 * i)),
                        max_new_tokens=5, temperature=0.8 * (i % 2))
                for i in range(4)]
        run_staggered(eng, staggered_groups(reqs, 2))
        outs[record] = [r.output for r in reqs]
        assert bool(eng.serve_records()) == record
        assert bool(eng.nvm_verdicts()) == record
    assert outs[True] == outs[False]


# --- the train window's record against the JAX window's ---------------------

SEQ, BATCH = 512, 2


def test_train_records_match_jax(walker_texts):
    """Mirror of ``tests/test_train_engine.py::test_train_records_and_verdicts``
    on the port, then the record against the JAX window's on reduced
    llama3-8b (remat full: the recomputed forward is counted, as the
    walker counts it)."""
    over = dict(dtype="float32", remat="full")
    jcfg = jreduced(jget_config("llama3-8b"), **over)
    jmodel = jbuild_model(jcfg, max_seq=SEQ)
    jopt = JAdamW(lr=jconstant(1e-3))
    jwin = jmake_train_window(jmodel, jopt, steps_per_sync=2,
                              data_cfg=JDataConfig(jcfg.vocab_size, SEQ,
                                                   BATCH))
    jstate, _ = jwin(jinit_state(jmodel, jopt, jax.random.PRNGKey(0)))
    cfg = reduced(get_config("llama3-8b"), **over)
    model = build_model(cfg, max_seq=SEQ, device="cpu")
    opt = AdamW(lr=constant(1e-3))
    win = make_train_window(model, opt, steps_per_sync=2,
                            data_cfg=DataConfig(cfg.vocab_size, SEQ, BATCH))
    assert win.train_records() == []             # nothing ran yet
    state = init_state(model, opt, torch.Generator().manual_seed(0))
    state, _ = win(state)
    state, _ = win(state)
    recs = win.train_records()
    assert len(recs) == 1 and recs[0]["kind"] == "train"
    assert recs[0]["steps"] == 4                 # 2 windows x K=2
    assert recs[0]["shape"] == f"train_window_b{BATCH}_s{SEQ}_k2"
    # forward + remat recompute, per layer and step, in the counted window
    assert win._traffic.kernel_calls == {
        "flash_attention": 2 * cfg.num_layers * 2}
    j = jwin.train_records()[0]
    assert recs[0]["shape"] == j["shape"]
    r, jr = recs[0]["roofline"], j["roofline"]
    assert r["flops_per_device"] == pytest.approx(jr["flops_per_device"],
                                                  rel=0.05)
    moves = _walker_moves(walker_texts[id(jwin._traffic)]) / 2
    lo, hi = BYTE_BANDS[("dense", "train")]
    assert lo <= _byte_ratio(j["shape"], r["bytes_per_device"],
                             jr["bytes_per_device"], moves) <= hi
    verdicts = win.nvm_verdicts()
    assert len(verdicts) == 1
    for mem in ("STT", "SOT"):
        assert verdicts[0].energy_ratio[mem] > 0
        assert verdicts[0].edp_ratio[mem] > 0
    # memory bound at this width: the ratios do not depend on the bytes
    assert r["memory_s"] > r["compute_s"] and jr["memory_s"] > jr["compute_s"]
    jv = jcl.analyze_train([j])[0]
    for mem in ("STT", "SOT"):
        _close(verdicts[0].energy_ratio[mem], jv.energy_ratio[mem], 1e-4)
        _close(verdicts[0].edp_ratio[mem], jv.edp_ratio[mem], 1e-4)


@pytest.mark.parametrize("arch,kernel", [("mamba2-1.3b", "ssd_scan"),
                                         ("granite-moe-3b-a800m",
                                          "flash_attention"),
                                         ("whisper-tiny",
                                          "flash_attention")])
def test_train_records_of_the_ssm_and_moe_families_match_jax(
        arch, kernel, walker_texts):
    """The train window's record on reduced mamba2 (the SSD scan under
    autograd: kernel forward, plain backward), granite (the router's
    dispatch and its backward) and whisper (on tokens alone, as both
    windows train it: the decoder with no cross-attention, and zero
    gradients for the weights it does not reach) against the JAX
    window's, remat full: flops within 5%, bytes in their band, one
    kernel call per (decoder) layer and step for the forward and one for
    the recompute, and the verdicts within 1e-4 of JAX's
    ``analyze_train`` (``TRAIN_READ_FRACTION`` for every family, as
    there)."""
    over = dict(dtype="float32", remat="full")
    jcfg = jreduced(jget_config(arch), **over)
    jmodel = jbuild_model(jcfg, max_seq=SEQ)
    jopt = JAdamW(lr=jconstant(1e-3))
    jwin = jmake_train_window(jmodel, jopt, steps_per_sync=2,
                              data_cfg=JDataConfig(jcfg.vocab_size, SEQ,
                                                   BATCH))
    jwin(jinit_state(jmodel, jopt, jax.random.PRNGKey(0)))
    cfg = reduced(get_config(arch), **over)
    model = build_model(cfg, max_seq=SEQ, device="cpu")
    opt = AdamW(lr=constant(1e-3))
    win = make_train_window(model, opt, steps_per_sync=2,
                            data_cfg=DataConfig(cfg.vocab_size, SEQ, BATCH))
    win(init_state(model, opt, torch.Generator().manual_seed(0)))
    (rec,), (j,) = win.train_records(), jwin.train_records()
    assert rec["shape"] == j["shape"] and rec["steps"] == 2
    # whisper on tokens alone trains a dense decoder stack (LayerNorm,
    # learned positions, no cross-attention): the dense band holds it
    family, layers = cfg.family, cfg.num_layers
    if family == "encdec":
        family, layers = "dense", cfg.dec_layers
    assert win._traffic.kernel_calls == {kernel: 2 * layers * 2}
    r, jr = rec["roofline"], j["roofline"]
    assert r["flops_per_device"] == pytest.approx(jr["flops_per_device"],
                                                  rel=0.05)
    moves = _walker_moves(walker_texts[id(jwin._traffic)]) / 2
    lo, hi = BYTE_BANDS[(family, "train")]
    assert lo <= _byte_ratio(j["shape"], r["bytes_per_device"],
                             jr["bytes_per_device"], moves) <= hi
    assert r["memory_s"] > r["compute_s"] and jr["memory_s"] > jr["compute_s"]
    jv, = jcl.analyze_train([j])
    v, = win.nvm_verdicts()
    assert v.reads / (v.reads + v.writes) == pytest.approx(
        cl.TRAIN_READ_FRACTION, rel=1e-6)
    for mem in ("STT", "SOT"):
        _close(v.energy_ratio[mem], jv.energy_ratio[mem], 1e-4)
        _close(v.edp_ratio[mem], jv.edp_ratio[mem], 1e-4)


def test_recording_changes_no_loss():
    over = dict(dtype="float32", num_layers=1, d_model=16, d_ff=32,
                num_heads=1, num_kv_heads=1, head_dim=16, vocab_size=128)
    cfg = reduced(get_config("llama3-8b"), **over)
    model = build_model(cfg, max_seq=8, device="cpu")
    opt = AdamW(lr=constant(1e-3))
    out = {}
    for record in (True, False):
        win = make_train_window(model, opt, steps_per_sync=2,
                                data_cfg=DataConfig(cfg.vocab_size, 8, 4),
                                record_traffic=record)
        state = init_state(model, opt, torch.Generator().manual_seed(0))
        losses = []
        for _ in range(2):
            state, m = win(state)
            losses += m["loss"].tolist() + m["grad_norm"].tolist()
        out[record] = (losses, state["params"])
        assert bool(win.train_records()) == record
        assert bool(win.nvm_verdicts()) == record
    assert out[True][0] == out[False][0]
    assert all(torch.equal(out[True][1][n], out[False][1][n])
               for n in out[True][1])


# --- launchers and the example ----------------------------------------------

VERDICT_LINE = re.compile(r"^  (serve|train)_\w+: energy vs SRAM "
                          r"STT \d+\.\d{3} / SOT \d+\.\d{3}   EDP "
                          r"STT \d+\.\d{3} / SOT \d+\.\d{3}$")


def _verdict_lines(text):
    return [ln for ln in text.splitlines() if "energy vs SRAM" in ln]


@pytest.mark.parametrize("verdicts", [True, False])
def test_launchers_print_verdicts(verdicts, tmp_path):
    flag = [] if verdicts else ["--no-verdicts"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        launch_serve.main(["--device", "cpu", "--requests", "4",
                           "--slots", "2", "--max-len", "32"] + flag)
    lines = _verdict_lines(buf.getvalue())
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = launch_train.main(["--device", "cpu", "--reduced", "--steps",
                                "4", "--steps-per-sync", "2", "--seq", "16",
                                "--batch", "2", "--ckpt-dir",
                                str(tmp_path / "ck")] + flag)
    assert rc == 0
    tlines = _verdict_lines(buf.getvalue())
    if not verdicts:
        assert lines == [] and tlines == []
        return
    assert any("serve_dense_decode_b2_l32" in ln for ln in lines)
    assert any("_prefill_p" in ln for ln in lines)
    assert tlines == [tlines[0]] and "train_window_b2_s16_k2" in tlines[0]
    assert all(VERDICT_LINE.match(ln) for ln in lines + tlines)


def test_nvm_sweep_equals_the_jax_example(tmp_path, monkeypatch):
    """The port's example prints, line for line, what
    ``examples/nvm_sweep.py`` prints; with dry-run records present it
    prints their verdicts."""
    src = (ROOT / "examples" / "nvm_sweep.py").read_text()
    jbuf = io.StringIO()
    with redirect_stdout(jbuf):
        exec(compile(src, "nvm_sweep.py", "exec"),
             {"__name__": "sweep",
              "__file__": str(ROOT / "examples" / "nvm_sweep.py")})
    buf = io.StringIO()
    with redirect_stdout(buf):
        nvm_sweep.main(["--device", "cpu"])
    assert buf.getvalue() == jbuf.getvalue()
    for i in range(2):
        (tmp_path / f"c{i}__baseline.json").write_text(
            json.dumps(_rec(f"c{i}")))
    lines = nvm_sweep.report("cpu", results=tmp_path)
    assert lines[-3] == "\n=== TPU cross-layer verdicts (2 dry-run cells) ==="
    for ln, v in zip(lines[-2:], cl.analyze_dryrun_dir(str(tmp_path),
                                                       device="cpu")):
        assert f"EDP STT {v.edp_ratio['STT']:.2f}" in ln
