"""The same tiny runs with the timed path broken underneath (a greedy or a
sampled token altered where it is produced; sampled rows taken greedily;
a train step that leaves its state unchanged; half of each batch left
out) come out not correct, and the control (the reference through float8
products put in the program's place) reads well above the program and
comes out not correct through the cell's limits."""
import pytest
import torch

from portbench import serve, train
from portbench.control import readings
from portbench.run import Ctx
from portbench.tests import tiny


def _alter_tokens(engine, sampled=False):
    sample = engine._sample
    vocab = engine.model.cfg.vocab_size

    def altered(lg, temps):
        tok = sample(lg, temps)
        hit = temps > 0 if sampled else temps <= 0
        return torch.where(hit, (tok + 1) % vocab, tok)

    engine._sample = altered


def _alter_sampled_tokens(engine):
    _alter_tokens(engine, sampled=True)


def _greedy_for_sampled(engine):
    sample = engine._sample

    def greedy(lg, temps):
        return sample(lg, torch.zeros_like(temps))

    engine._sample = greedy


def _unchanged_state(window):
    step = window._step_fn

    def frozen(state, batch):
        keep = {k: {n: t.clone() for n, t in v.items()}
                for k, v in state["opt"].items() if isinstance(v, dict)}
        params = {n: t.clone() for n, t in state["params"].items()}
        state, metrics = step(state, batch)
        for k, v in keep.items():
            for n, t in v.items():
                state["opt"][k][n].copy_(t)
        for n, t in params.items():
            state["params"][n].copy_(t)
        return state, metrics

    window._step_fn = frozen


def _half_batch(window):
    step = window._step_fn

    def half(state, batch):
        rows = batch["tokens"].shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()})

    window._step_fn = half


@pytest.mark.parametrize("name,plant", [
    (tiny.SERVE, _alter_tokens),
    (tiny.SERVE, _alter_sampled_tokens),
    (tiny.DOCQA, _greedy_for_sampled),
    (tiny.DENSE_TRAIN, _unchanged_state),
    (tiny.DENSE_TRAIN, _half_batch)])
def test_a_broken_run_is_not_correct(name, plant):
    line = tiny.run(name, plant=plant)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", [tiny.SERVE, tiny.DENSE_TRAIN])
def test_the_control_reads_above_the_program(name):
    c = tiny.cell(name)
    c["workload"]["check"].update(tokens=120, max_requests=12)
    driver = serve if c["workload"]["kind"] == "serve" else train
    for seed in (tiny.SEED, 5):
        ctx = Ctx(c, seed, 3.0, False, tiny.CPU, age=lambda: 1.0)
        r = readings(ctx, driver, driver.run(ctx))
        if driver is serve:
            assert r["served_tokens"] >= 60, r
            lim = c["workload"]["check"]["sample_z"]
            assert r["faults"]["sample_z"]["altered"] > lim, r
        assert any(r["control"][k] >= 3 * max(v, 1e-9)
                   for k, v in r["program"].items()), r
        assert not r["control_correct"], r
