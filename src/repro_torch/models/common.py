"""Parameter system + shared neural-net primitives (torch counterpart of
``repro/models/common.py``).

Parameters live in a FLAT dict keyed by '/'-separated path, in the JAX
package's layouts; layer stacks carry a leading "layers" dim.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | const
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in) for normal
    const: float = 0.0
    dtype: Optional[str] = None

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


ParamDefs = Dict[str, ParamDef]


def _fan_in(shape: Tuple[int, ...]) -> int:
    # heuristically treat all but the last dim as fan-in for >=2D weights
    if len(shape) <= 1:
        return shape[0] if shape else 1
    return int(np.prod(shape[:-1]))


def materialize(defs: ParamDefs, generator: Optional[torch.Generator],
                dtype: str, device: torch.device) -> Params:
    """The init rules of ``repro.models.common.materialize`` (fan-in
    scaled normals, zeros, ones, const) with draws from a
    ``torch.Generator`` — same distributions, different numbers.  Normal
    draws are made on the generator's device in float32, in sorted name
    order, then cast and moved to ``device``."""
    params: Params = {}
    for name, d in sorted(defs.items()):
        dt = torch_dtype(d.dtype or dtype)
        if d.init == "zeros":
            params[name] = torch.zeros(d.shape, dtype=dt, device=device)
        elif d.init == "ones":
            params[name] = torch.ones(d.shape, dtype=dt, device=device)
        elif d.init == "const":
            params[name] = torch.full(d.shape, d.const, dtype=dt,
                                      device=device)
        else:
            if generator is None:
                raise ValueError(f"{name}: a normal init needs a generator")
            scale = (d.scale if d.scale is not None
                     else _fan_in(d.shape) ** -0.5)
            w = torch.randn(d.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            params[name] = w.mul_(scale).to(device=device, dtype=dt)
    return params


def stacked(defs: ParamDefs, n: int, prefix: str) -> ParamDefs:
    """Stack per-layer defs with a leading "layers" dim."""
    return {
        f"{prefix}/{k}": dataclasses.replace(
            d, shape=(n,) + d.shape, axes=("layers",) + d.axes)
        for k, d in defs.items()
    }


def subtree(params: Params, prefix: str) -> Params:
    pre = prefix + "/"
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm scaled by ``1 + gamma`` (gamma initialises to zeros) —
    not ``torch.nn.RMSNorm``, which scales by ``gamma``."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + gamma.float())).to(dt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 scaled by ``gamma`` itself (it initialises to
    ones, unlike ``rms_norm``'s ``1 + gamma``), shifted by ``beta``."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * gamma.float() + beta.float()).to(dt)


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """f32 cos/sin tables (..., S, 1, hd/2) of the rotary angles
    ``positions * theta**(-i/half)``.  They depend on positions only, so a
    forward pass makes them once and every layer shares them (building
    them from a Python float, with no host-to-device copy)."""
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freq = torch.pow(theta, -ar / half)
    angles = positions[..., None].float() * freq       # (..., S, half)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Half-split (NeoX-style) rotation of x (..., S, H, hd) in f32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    return apply_rope(x, *rope_tables(positions, x.shape[-1], theta))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` forms it
    (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


@functools.lru_cache(maxsize=8)
def _sinusoids(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    div = np.exp(-np.log(10000.0) * np.arange(0, dim, 2) / dim)
    out = np.zeros((length, dim), np.float32)
    out[:, 0::2] = np.sin(pos * div)
    out[:, 1::2] = np.cos(pos * div)
    out.setflags(write=False)
    return out


def sinusoidal_positions(length: int, dim: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """The (length, dim) f32 sinusoid table of the whisper encoder, formed
    in numpy float64 and cast to f32 as the JAX package forms it (so the
    two tables are equal bit for bit), on ``device``."""
    return torch.tensor(_sinusoids(length, dim), device=device)


def activation(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  final_cap: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy over f32 logits after the final softcap,
    as ``repro.models.common.cross_entropy`` forms it (the JAX train loss
    applies ``final_cap`` here although ``_unembed`` applied it already;
    the port keeps both)."""
    logits = softcap(logits.float(), final_cap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)
