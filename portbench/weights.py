"""Weights from the seed, made on the device in a few large calls, in the
type they are served in (bf16), and handed alike to the program and to
the reference.

The tensors are named and shaped as the port's flat parameter dict holds
them (layers stacked on a leading axis under ``blocks/``);
``check_layout`` holds the two against each other.  The draws are the
benchmark's own: normals scaled by each product's fan-in, 0.02 for the
embedding, and small random norm gains and biases (so that a program that
drops one is seen)."""
from __future__ import annotations

from typing import Dict, Tuple

import torch

GAIN_STD = 0.1      # norm gains (the scale is 1 + gain) and q/k/v biases


def layout(arch: dict) -> Dict[str, Tuple[Tuple[int, ...], float]]:
    """{name: (shape, standard deviation)} of every weight."""
    L, D, H, K, hd, F, V = (arch[k] for k in
                            ("L", "D", "H", "K", "hd", "F", "V"))
    out = {"emb/tok": ((V, D), 0.02), "final_ln/g": ((D,), GAIN_STD),
           "blocks/ln1/g": ((L, D), GAIN_STD),
           "blocks/ln2/g": ((L, D), GAIN_STD),
           "blocks/attn/wq": ((L, D, H, hd), D ** -0.5),
           "blocks/attn/wk": ((L, D, K, hd), D ** -0.5),
           "blocks/attn/wv": ((L, D, K, hd), D ** -0.5),
           "blocks/attn/wo": ((L, H, hd, D), (H * hd) ** -0.5),
           "blocks/mlp/w_up": ((L, D, F), D ** -0.5),
           "blocks/mlp/w_gate": ((L, D, F), D ** -0.5),
           "blocks/mlp/w_down": ((L, F, D), F ** -0.5)}
    if not arch["tied"]:
        out["emb/out"] = ((D, V), D ** -0.5)
    if arch["qkv_bias"]:
        out["blocks/attn/bq"] = ((L, H, hd), GAIN_STD)
        out["blocks/attn/bk"] = ((L, K, hd), GAIN_STD)
        out["blocks/attn/bv"] = ((L, K, hd), GAIN_STD)
    return out


def make(arch: dict, seed: int, device,
         dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every weight drawn from ``torch.Generator(device).manual_seed(seed)``
    in sorted name order, directly in ``dtype``: the same seed gives the
    same tensors, bit for bit, on one device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, (shape, std) in sorted(layout(arch).items()):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        out[name] = t.mul_(std)
    return out


def check_layout(arch: dict, param_defs) -> None:
    """Raise unless the names and shapes match the port's parameters."""
    mine = {n: s for n, (s, _) in layout(arch).items()}
    theirs = {n: tuple(d.shape) for n, d in param_defs.items()}
    if mine != theirs:
        diff = sorted(set(mine.items()) ^ set(theirs.items()))
        raise ValueError(f"weight layout differs from the port's: {diff}")
