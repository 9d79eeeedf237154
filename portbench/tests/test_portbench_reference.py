"""The float32 reference against the port at a tiny width on the CPU, on
the same weights and inputs, both in float32: logits of a prompt, the
training loss and its gradients (with and without recomputation), the
training rows the window hashes, and three AdamW steps."""
import dataclasses

import pytest
import torch

from portbench import weights
from portbench.cell import architecture, port_config
from portbench.reference import data, decoder
from portbench.reference import train as ref_train
from portbench.reference.numerics import Numerics
from portbench.tests import tiny

CPU = torch.device("cpu")


def _port(cell_name, **arch_over):
    from repro_torch.models import build_model
    c = tiny.cell(cell_name)
    A = architecture(c["config"])
    A.update(arch_over)
    cfg = dataclasses.replace(port_config(A, "tiny", remat="none"),
                              dtype="float32")
    model = build_model(cfg, max_seq=64, device="cpu")
    W = weights.make(A, 2 ** 31 + 9, CPU, dtype=torch.float32)
    weights.check_layout(A, model.param_defs)
    return A, model, W, c


@pytest.mark.parametrize("cell", [tiny.SERVE, tiny.DENSE_TRAIN])
def test_logits_match_the_port(cell):
    A, model, W, _ = _port(cell)
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, A["V"], (1, 40), generator=g)
    logits, _ = model.prefill(W, {"tokens": tokens}, attn_impl="plain")
    at = torch.arange(40)
    ref = decoder.sequence_logits(A, W, tokens[0], at)
    assert torch.allclose(logits[0], ref, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_the_port(remat):
    A, model, W, _ = _port(tiny.DENSE_TRAIN)
    tokens, labels = data.batch(7, 0, 2, 48, A["V"], CPU)
    leaves = {n: w.clone().requires_grad_() for n, w in W.items()}
    loss = model.loss(leaves, {"tokens": tokens.int(),
                               "labels": labels.int()}, attn_impl="plain")
    gp = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                             materialize_grads=True)
    rl = {n: w.clone().requires_grad_() for n, w in W.items()}
    ref = decoder.train_loss(A, Numerics(), rl, tokens, labels, remat=remat)
    gr = torch.autograd.grad(ref, list(rl.values()), allow_unused=True,
                             materialize_grads=True)
    assert abs(float(loss.detach()) - float(ref.detach())) < 1e-5
    for n, a, b in zip(leaves, gp, gr):
        assert torch.allclose(a, b, atol=2e-6, rtol=2e-4), n


def test_training_rows_are_the_windows():
    from repro_torch.data import DataConfig, device_batch_at
    for seed, step in ((0, 0), (2 ** 31 + 77, 5), (12345, 2)):
        b = device_batch_at(DataConfig(49155, 64, 4, seed=seed), step)
        t, lab = data.batch(seed, step, 4, 64, 49155, CPU)
        assert torch.equal(b["tokens"].long(), t)
        assert torch.equal(b["labels"].long(), lab)


def test_three_adamw_steps_match_the_port():
    from repro_torch.data import DataConfig
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train.trainer import TrainWindow
    A, model, W, c = _port(tiny.DENSE_TRAIN)
    recipe = {"lr": 1e-3, "warmup": 2, "total": 8, "batch": 4, "seq": 32,
              "microbatches": 2}
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 8))
    state = {"params": {n: w.clone() for n, w in W.items()},
             "opt": opt.init(W), "step": torch.zeros((), dtype=torch.int32)}
    win = TrainWindow(model, opt, DataConfig(A["V"], 32, 4, seed=11),
                      steps_per_sync=3, microbatches=2, attn_impl="plain",
                      record_traffic=False)
    state, m = win(state)
    ref = ref_train.run(A, W, recipe, 11, steps=3,
                        param_dtype=torch.float32)
    assert max(abs(a - b) for a, b in zip(m["loss"].tolist(),
                                          ref["loss"])) < 1e-5
    for n in W:
        got = float(torch.linalg.vector_norm(state["opt"]["master"][n]
                                             - W[n]))
        assert abs(got - ref["change"][n]) <= 1e-3 * max(ref["change"][n],
                                                         1e-6), n
