"""Weights bridge: the JAX package's parameter dict, as numpy arrays, into
the port's parameters, and a JAX train state into the port's.

Names and layouts are kept as they are (``wq (D,H,hd)``, ``wo (H,hd,D)``;
dense and ssm layers stacked on axis 0 under ``blocks/``, the hybrid
stack unrolled under ``layer_{i}/``, whisper's under ``enc_{i}/`` and
``dec_{i}/``), so a test can feed the same weights to both packages and
compare like with like.
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
    defs = _check_names(cfg, flat)
    return {name: _to_tensor(np.asarray(flat[name])).to(
        device=dev, dtype=torch_dtype(d.dtype or cfg.dtype))
        for name, d in defs.items()}


def _defs(cfg: ModelConfig, flat: Mapping[str, np.ndarray]):
    """The model's param defs, the encdec family's ``pos/dec`` table as
    long as ``flat``'s (the JAX model's ``max_seq``)."""
    max_seq = np.shape(flat["pos/dec"])[-2] if "pos/dec" in flat else 0
    return model_param_defs(cfg, max_seq)


def _check_names(cfg: ModelConfig, flat: Mapping[str, np.ndarray]):
    """The model's param defs; raises unless ``flat`` has exactly their
    names and shapes."""
    defs = _defs(cfg, flat)
    missing = sorted(set(defs) - set(flat))
    extra = sorted(set(flat) - set(defs))
    if missing or extra:
        raise ValueError(f"parameter names differ: missing {missing}, "
                         f"extra {extra}")
    for name, d in defs.items():
        shape = tuple(np.shape(flat[name]))
        if shape != tuple(d.shape):
            raise ValueError(f"{name}: shape {shape} != {tuple(d.shape)}")
    return defs


def train_state_from_numpy(cfg: ModelConfig, state: Mapping, *,
                           device: DeviceLike = None) -> dict:
    """A JAX ``TrainState`` as numpy -> the port's train state on
    ``device``.  Its optimizer state is AdamW's as ``AdamW.init`` builds it
    (``{"m", "v", "count"[, "master"]}``) or the compressed optimizer's
    (``{"inner": <AdamW state>, "err": {name: array}}``, each error buffer
    shaped like its parameter or, with shards, ``(shards, *shape)``).
    Params go through ``params_from_numpy``; moments, master weights and
    error buffers are f32 under the same names, count and step 0-d
    int32."""
    dev = resolve_device(device)

    def f32_tree(tree):
        _check_names(cfg, tree)
        return {n: _to_tensor(np.asarray(a, np.float32)).to(dev)
                for n, a in tree.items()}

    def int32(a):
        return torch.tensor(int(np.asarray(a)), dtype=torch.int32,
                            device=dev)

    def adamw(opt):
        unknown = sorted(set(opt) - {"m", "v", "count", "master"})
        if unknown:
            raise ValueError(f"optimizer state has keys {unknown} the "
                             f"port's AdamW does not carry")
        out = {"m": f32_tree(opt["m"]), "v": f32_tree(opt["v"]),
               "count": int32(opt["count"])}
        if "master" in opt:
            out["master"] = f32_tree(opt["master"])
        return out

    opt = state["opt"]
    if set(opt) == {"inner", "err"}:
        out_opt = {"inner": adamw(opt["inner"]),
                   "err": _err_tree(cfg, opt["err"], dev)}
    else:
        out_opt = adamw(opt)
    return {"params": params_from_numpy(cfg, state["params"], device=dev),
            "opt": out_opt, "step": int32(state["step"])}


def _err_tree(cfg: ModelConfig, tree: Mapping[str, np.ndarray],
              dev: torch.device) -> dict:
    """The compressed optimizer's error buffers: the parameters' names,
    each shaped like its parameter, or all with one leading shard axis."""
    defs = _defs(cfg, tree)
    if set(tree) != set(defs):
        raise ValueError(f"error buffer names differ: missing "
                         f"{sorted(set(defs) - set(tree))}, extra "
                         f"{sorted(set(tree) - set(defs))}")
    leads = set()
    for n, d in defs.items():
        shape = tuple(np.shape(tree[n]))
        if shape == tuple(d.shape):
            leads.add(())
        elif shape[1:] == tuple(d.shape):
            leads.add(shape[:1])
        else:
            raise ValueError(f"error buffer {n}: shape {shape} is neither "
                             f"{tuple(d.shape)} nor (shards, *that)")
    if len(leads) > 1:
        raise ValueError(f"error buffers with leading shapes "
                         f"{sorted(leads)}: want one for all")
    return {n: _to_tensor(np.asarray(a, np.float32)).to(dev)
            for n, a in tree.items()}
