"""The training rows of step ``step`` worked out again: the counter hash
the port's ``TrainWindow`` uses to make its batches on the card (a uint32
lowbias32 avalanche of (seed, step, host, index); token = (h1 mod vocab)
>> (h2 & 15)), here in int64 arithmetic kept to 32 bits."""
from __future__ import annotations

import torch

_MIX_A, _MIX_B = 0x7FEB352D, 0x846CA68B
_GOLDEN, _SALT = 0x9E3779B9, 0x85EBCA6B
_M32 = 0xFFFFFFFF


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    # x * c mod 2^32 for x < 2^32 held in int64, in two 16-bit halves of c
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, _MIX_A)
    x = x ^ (x >> 15)
    x = _mul(x, _MIX_B)
    return x ^ (x >> 16)


def batch(seed: int, step: int, rows: int, seq: int, vocab: int,
          device) -> tuple:
    """(tokens, labels), each (rows, seq) int64, of training step ``step``
    (0-based) on host 0."""
    def word(v):
        return torch.tensor([v & _M32], dtype=torch.int64, device=device)

    base = _mix(word(_GOLDEN) ^ (seed & _M32))
    base = _mix(base ^ (step & _M32))
    base = _mix(base ^ 0)
    idx = torch.arange(rows * (seq + 1), dtype=torch.int64, device=device)
    h1 = _mix(idx ^ base)
    h2 = _mix(h1 ^ _SALT)
    tok = ((h1 % vocab) >> (h2 & 15)).reshape(rows, seq + 1)
    return tok[:, :-1], tok[:, 1:]
