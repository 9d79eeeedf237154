"""Weights bridge: the JAX package's parameter dict, as numpy arrays, into
the port's parameters.

Names and layouts are kept as they are (``wq (D,H,hd)``, ``wo (H,hd,D)``;
dense and ssm layers stacked on axis 0 under ``blocks/``, the hybrid
stack unrolled under ``layer_{i}/``), so a test can feed the same weights
to both packages and compare like with like.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.common import Params, torch_dtype
from repro_torch.models.transformer import model_param_defs


def _to_tensor(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, as JAX gives
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(cfg: ModelConfig, flat: Mapping[str, np.ndarray], *,
                      device: DeviceLike = None) -> Params:
    """``{name: np.ndarray}`` with the names ``model.init`` produces in the
    JAX package -> the port's parameter dict on ``device``.  Raises on a
    missing, extra or mis-shaped name."""
    dev = resolve_device(device)
    defs = model_param_defs(cfg)
    missing = sorted(set(defs) - set(flat))
    extra = sorted(set(flat) - set(defs))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"extra {extra}")
    out: Params = {}
    for name, d in defs.items():
        t = _to_tensor(np.asarray(flat[name]))
        if tuple(t.shape) != tuple(d.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(d.shape)}")
        out[name] = t.to(device=dev,
                         dtype=torch_dtype(d.dtype or cfg.dtype))
    return out
