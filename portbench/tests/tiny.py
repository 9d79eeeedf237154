"""Cells of the manifest cut to a size a CPU test can run: the same files,
with the widths, depth, slots and traffic shrunk, and the limits of the
correctness numbers set for this size (a 64-wide model's bf16 rounding
reads differently from the card's full widths): sound runs read at most
a third of them, the planted faults over them
(``test_portbench_run.py``)."""
from __future__ import annotations

import copy

import torch

from portbench.cell import manifest, resolve

CPU = torch.device("cpu")
SEED = 2 ** 31 + 21


def cell(name: str) -> dict:
    c = copy.deepcopy(resolve(name, manifest()))
    cfg = c["config"]["config"]
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=128, vocab_size=512)
    c["config"]["architecture"]["head_dim"] = 16
    if c["workload"]["kind"] == "serve":
        c["workload"]["engine"].update(slots=4, max_len=128)
        t = c["traffic"]
        t.update(clients=4, pool=16, ramp=2, warmup_steps=3)
        t["prompt"].update(median=24, min=4, max=96)
        t["output"].update(median=6, min=1, max=24)
        c["workload"]["check"].update(tokens=40, max_requests=4,
                                      logit_gap=0.15, sampled_tokens=160,
                                      sampled_requests=16, sample_z=4.5)
    else:
        c["traffic"].update(batch=4, seq=32)
        c["workload"]["check"].update(loss=2e-3, grad=0.06, change=0.04)
    return c


SERVE = "qwen2-7b.serve.conversation"
DOCQA = "qwen2-7b.serve.docqa"
DENSE_TRAIN = "qwen2-7b.train.s2048"


def run(name, trace=False, plant=None, seconds=3.0):
    """One whole run of the tiny cell on the CPU (the harness's look for a
    card skipped); seconds-long windows, so that a loaded machine still
    finishes enough requests for the check."""
    from portbench.run import run_cell
    return run_cell(cell(name), SEED, seconds, trace, CPU, plant=plant,
                    age=lambda: 1.0)
