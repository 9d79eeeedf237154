"""The port's trace-driven LRU cache simulator (``repro_torch.core.cachesim``
and ``repro_torch.kernels.cache_sim``) against the JAX package, on the CPU.

On CPU tensors the wrappers take the plain PyTorch version (stable sort by
set, one tensor-op round per access rank), so these tests pin it, the CUDA
kernels' oracle, to the Pallas kernels (interpret mode, as
``tests/test_cachesim.py`` runs them) and to the reference's numpy and
OrderedDict oracles.  Every count is compared exactly.  They also pin what
the CUDA wrappers do around the kernels: argument checks, device dispatch,
launch counting, and the tile bookkeeping, through a stand-in for the
compiled library that computes each tile's counts with the numpy oracle.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")   # CI images without PyTorch skip

from repro.core import cachesim as jcs
from repro.kernels import cache_sim as jks
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import cachesim as cs
from repro_torch.core.sweep import capacity_ladder
from repro_torch.kernels import _build, ops
from repro_torch.kernels import cache_sim as ks

CPU = "cpu"


def _zipf_trace(n, footprint, seed=0, theta=1.3):
    rng = np.random.RandomState(seed)
    return (rng.zipf(theta, n) % footprint).astype(np.int64)


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int32))


# --- plain LRU against the Pallas kernels and the oracles --------------------


@pytest.mark.parametrize("nsets,ways,tile,n", [
    (1, 1, 1, 400),       # single direct-mapped line
    (1, 16, 1, 400),      # one set, full associativity
    (8, 1, 8, 600),       # direct-mapped, several sets
    (32, 4, 8, 800),
    (64, 8, 64, 800),
    (81, 16, 27, 600),    # odd set count, non-power-of-two tile
])
def test_cache_sim_plain_matches_pallas_and_oracles(nsets, ways, tile, n):
    sid = _zipf_trace(n, 10 * nsets, seed=nsets + ways) % nsets
    tags = _zipf_trace(n, 700, seed=nsets)
    h1, m1 = jops.cache_sim(jnp.asarray(sid), jnp.asarray(tags),
                            num_sets=nsets, ways=ways, sets_tile=tile)
    want = (int(h1), int(m1))
    assert jref.cache_sim_numpy(sid, tags, num_sets=nsets,
                                ways=ways) == want
    assert jref.cache_sim_python(sid, tags, num_sets=nsets,
                                 ways=ways) == want
    got = ops.cache_sim(_i32(sid), _i32(tags), num_sets=nsets, ways=ways,
                        sets_tile=tile)
    assert got.dtype == torch.int64 and tuple(got.tolist()) == want
    assert sum(want) == n


@pytest.mark.parametrize("ways,num_sets,tile", [
    (4, (1, 3, 7, 20, 33), 8),    # partial tiles, odd rungs
    (1, (1, 2, 5), 4),            # ways=1 ladder
    (16, (1,), 1),                # single fully-associative rung
    (16, (16, 23, 96), 32),       # whole-octave style with 3 MB at 1:16
])
def test_ladder_plain_matches_pallas_and_oracle(ways, num_sets, tile):
    traces = np.stack([_zipf_trace(600, 500, seed=s) for s in (0, 1)])
    want = np.asarray(jops.cache_sim_ladder(jnp.asarray(traces, jnp.int32),
                                            num_sets=num_sets, ways=ways,
                                            sets_tile=tile))
    np.testing.assert_array_equal(
        want, jref.cache_sim_ladder_numpy(traces, num_sets, ways=ways))
    got = ops.cache_sim_ladder(_i32(traces), num_sets=num_sets, ways=ways,
                               sets_tile=tile)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(2) == traces.shape[1]).all()


def test_plain_lru_on_a_hand_trace():
    """Empty ways fill in order, the oldest way is the victim, a re-used
    line is a hit: one set of 2 ways over tags 5 6 5 7 6 5."""
    tags = [5, 6, 5, 7, 6, 5]
    # 5 miss(w0) 6 miss(w1) 5 hit(w0) 7 miss(evicts 6 in w1) 6 miss
    # (evicts 5 in w0) 5 miss (evicts 7)
    got = ks.cache_sim_plain(_i32([0] * 6), _i32(tags), num_sets=1, ways=2)
    assert got.tolist() == [1, 5]
    assert jref.cache_sim_python([0] * 6, tags, num_sets=1, ways=2) == (1, 5)
    assert ks.cache_sim_plain(_i32([]), _i32([]), num_sets=4,
                              ways=2).tolist() == [0, 0]


# --- the driver against the JAX driver ----------------------------------------


def test_synthetic_traces_are_bitwise_the_references():
    np.testing.assert_array_equal(
        cs.synthetic_traces(5000, 65536, seeds=(0, 3)),
        jcs.synthetic_traces(5000, 65536, seeds=(0, 3)))
    assert cs.synthetic_trace(100, 977, theta=1.5, seed=2).tolist() == \
        jcs.synthetic_trace(100, 977, theta=1.5, seed=2).tolist()


def test_simulate_ladder_bit_exact_vs_reference_and_jax():
    ladder = capacity_ladder()            # the iso-area search ladder
    traces = cs.synthetic_traces(500, 4096, seeds=(0, 1))
    engine = cs.simulate_ladder(traces, ladder, scale=256, ways=16,
                                device=CPU)
    assert engine.dtype == np.int64 and engine.shape == (2, len(ladder), 2)
    per_point = np.stack([
        np.stack([np.asarray(cs.simulate_reference(
            tr, cs.capacity_lines(c, scale=256), ways=16, device=CPU))
            for c in ladder])
        for tr in traces])
    np.testing.assert_array_equal(engine, per_point)
    np.testing.assert_array_equal(
        engine, cs.simulate_ladder(traces, ladder, scale=256, ways=16,
                                   use_kernel=False, device=CPU))
    np.testing.assert_array_equal(
        engine, jcs.simulate_ladder(traces, ladder, scale=256, ways=16))


@pytest.mark.parametrize("ways,cap_lines", [(4, 81 * 4), (16, 96 * 16),
                                            (1, 7), (16, 8)])
def test_simulate_reference_matches_jax(ways, cap_lines):
    trace = _zipf_trace(700, 3000, seed=9)
    want = jcs.simulate_reference(trace, cap_lines, ways=ways)
    assert cs.simulate_reference(trace, cap_lines, ways=ways,
                                 device=CPU) == want
    assert cs.simulate_reference(trace, cap_lines, ways=ways,
                                 use_kernel=False, device=CPU) == want


def test_largest_divisor_tile_and_capacity_lines_match_jax():
    for n, t in ((81, 64), (100, 64), (61, 64), (4096, 64), (1, 64),
                 (30, 7), (11585, 256), (1536, 256)):
        assert cs.largest_divisor_tile(n, t) == \
            jcs.largest_divisor_tile(n, t)
    for c, scale in ((3.0, 1), (0.5 * 2 ** 0.5, 1), (64.0, 16), (7.0, 32)):
        assert cs.capacity_lines(c, scale=scale) == \
            jcs.capacity_lines(c, scale=scale)
    assert cs.ANALYTIC_TOL_PCT == jcs.ANALYTIC_TOL_PCT


def test_simulate_ladder_rejects_line_ids_wider_than_int32():
    trace = np.array([2 ** 32 - 2, 123, 456, 789], np.int64)
    with pytest.raises(ValueError, match="int32"):
        cs.simulate_ladder(trace, (3.0,), scale=4096, device=CPU)
    with pytest.raises(ValueError, match="int32"):
        cs.simulate_ladder(np.array([-1, 5]), (3.0,), scale=4096,
                           device=CPU)


def test_dram_curves_match_jax():
    kw = dict(trace_len=4000, scale=256)
    assert cs.dram_reduction_curve(device=CPU, **kw) == \
        jcs.dram_reduction_curve(**kw)
    assert cs.trace_dram_scale([7.0, 10.0, 3.0], device=CPU, **kw) == \
        jcs.trace_dram_scale([7.0, 10.0, 3.0], **kw)


# --- wrappers around the CUDA kernels -------------------------------------------


def test_ladder_tiles_match_the_pallas_bookkeeping():
    for ladder, tile in (((1, 3, 7, 20, 33), 8), ((16, 23, 96), 32),
                         ((256, 362, 1536), 256), ((5,), 1024)):
        assert ks.ladder_tiles(ladder, tile) == jks.ladder_tiles(ladder,
                                                                 tile)
    with pytest.raises(ValueError, match="ladder"):
        ks.ladder_tiles((4, 0), 8)


def test_plain_path_counts_no_launches_and_odd_devices_raise():
    ops.reset_launches()
    ops.cache_sim(_i32([0, 1]), _i32([3, 3]), num_sets=2, ways=2)
    ops.cache_sim_ladder(_i32([[0, 1, 2]]), num_sets=(1, 3), ways=2)
    assert ops.launches["cache_sim"] == ops.launches["cache_sim_ladder"] == 0
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.cache_sim(meta, meta, num_sets=2, ways=2)
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.cache_sim_ladder(meta.view(1, 4), num_sets=(2,), ways=2)
    with pytest.raises(ValueError, match="several devices"):
        ops.cache_sim(_i32([0]), meta[:1], num_sets=1, ways=1)


@pytest.mark.parametrize("change,match", [
    (dict(ways=17), "ways must be"),
    (dict(ways=0), "ways must be"),
    (dict(sets_tile=2048), "sets_tile"),
    (dict(num_sets=12, sets_tile=8), "multiple"),
    (dict(dtype=torch.int64), "int32"),
    (dict(tags_len=5), "differ in shape"),
])
def test_cache_sim_kernel_argument_checks(change, match):
    a = dict(ways=4, sets_tile=4, num_sets=8, dtype=torch.int32, tags_len=6)
    a.update(change)
    sid = torch.zeros(6, dtype=a["dtype"])
    tags = torch.zeros(a["tags_len"], dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        ks.check_args(sid, tags, a["num_sets"], a["ways"], a["sets_tile"])


def test_ladder_kernel_argument_checks():
    with pytest.raises(ValueError, match="2-d int32"):
        ks.check_ladder_args(torch.zeros(8, dtype=torch.int32), 4, 8)
    with pytest.raises(ValueError, match="ways must be"):
        ks.check_ladder_args(torch.zeros(2, 8, dtype=torch.int32), 32, 8)
    with pytest.raises(ValueError, match="65535 traces"):
        ks.check_ladder_args(torch.zeros(0, 8, dtype=torch.int32), 4, 8)
    too_long = torch.empty(1, ks.MAX_LEN + 1, dtype=torch.int32,
                           device="meta")             # allocates nothing
    with pytest.raises(ValueError, match="at most"):
        ks.check_ladder_args(too_long, 4, 8)


def _array(ptr: int, n: int) -> np.ndarray:
    return np.ctypeslib.as_array((ctypes.c_int32 * max(n, 1)).from_address(
        ptr))[:n]


def _fake_cache_sim(sid_p, tag_p, out_p, T, n_tiles, tile, ways, stream):
    """Stand-in for ``csrc/cache_sim.cu::cache_sim``: each tile's counts
    from the numpy oracle over the accesses of its sets."""
    sid, tags = _array(sid_p, T), _array(tag_p, T)
    out = _array(out_p, 2 * n_tiles).reshape(n_tiles, 2)
    for b in range(n_tiles):
        sel = (sid >= b * tile) & (sid < (b + 1) * tile)
        out[b] = jref.cache_sim_numpy(sid[sel] - b * tile, tags[sel],
                                      num_sets=tile, ways=ways)
    return 0


def _fake_ladder(tr_p, ns_p, base_p, out_p, W, T, G, tile, ways, stream):
    """Stand-in for ``csrc/cache_sim.cu::cache_sim_ladder``."""
    traces = _array(tr_p, W * T).reshape(W, T)
    ns, base = _array(ns_p, G), _array(base_p, G)
    out = _array(out_p, W * G * 2).reshape(W, G, 2)
    for w in range(W):
        for g in range(G):
            sid, tags = traces[w] % ns[g], traces[w] // ns[g]
            sel = (sid >= base[g]) & (sid < base[g] + tile)
            out[w, g] = jref.cache_sim_numpy(sid[sel], tags[sel],
                                             num_sets=ns[g], ways=ways)
    return 0


def test_launchers_marshal_and_reduce_tiles(monkeypatch):
    """The launchers' argument order, tile metadata and tile -> rung sums,
    on CPU tensors through stand-ins for the compiled functions."""
    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: _Stream())
    traces = np.stack([_zipf_trace(700, 900, seed=s) for s in (5, 6, 7)])
    ladder = (1, 3, 7, 20, 33, 96)
    got = ks.launch_ladder_cuda(_fake_ladder, _i32(traces), ladder, 4, 8)
    np.testing.assert_array_equal(
        got.numpy(), jref.cache_sim_ladder_numpy(traces, ladder, ways=4))
    sid, tags = traces[0] % 96, traces[0] // 96
    got = ks.launch_cuda(_fake_cache_sim, _i32(sid), _i32(tags), 96, 16, 32)
    assert tuple(got.tolist()) == jref.cache_sim_numpy(sid, tags,
                                                       num_sets=96, ways=16)

    def failing(*args):
        return 9
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        ks.launch_ladder_cuda(failing, _i32(traces), ladder, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        ks.launch_cuda(failing, _i32(sid), _i32(tags), 96, 16, 32)


def test_c_interface_matches_the_ctypes_declarations():
    """The ``extern "C"`` functions of ``csrc/cache_sim.cu`` take as many
    arguments as ``ARGTYPES`` declares (ctypes cannot check it)."""
    src = (_build.CSRC / "cache_sim.cu").read_text()
    for name, argtypes in (("cache_sim", ks.ARGTYPES),
                           ("cache_sim_ladder", ks.LADDER_ARGTYPES)):
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes), name
        pointers = [p.endswith(("void* stream",)) or "*" in p
                    for p in params]
        assert pointers == [t is ctypes.c_void_p for t in argtypes], name
    assert f"kMaxWays = {ks.MAX_WAYS};" in src
    assert f"kMaxTile = {ks.MAX_TILE};" in src
