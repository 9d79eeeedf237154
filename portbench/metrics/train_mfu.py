"""train_mfu: model flops of the window's unprofiled train steps (6 x the
matrix parameters a token, the head counted and the embedding lookup not, and causal attention forward
and backward: ``flops.train_flops_per_sequence``) over those steps' host
seconds at 989 TFLOP/s bf16; layer device.  Moves ``train_tok_s``."""
from portbench.flops import train_flops_per_sequence
from portbench.peaks import BF16_FLOPS_PER_S
from portbench.readers import unprofiled


def read(pl):
    calls, seconds = unprofiled(pl)
    if seconds <= 0:
        return None
    A, mix = pl["arch"], pl["traffic"]
    rows = sum(c["steps"] for c in calls) * mix["batch"]
    work = rows * train_flops_per_sequence(A, mix["seq"])
    return 100.0 * work / (seconds * BF16_FLOPS_PER_S)
