"""Architecture registry: ``get_config("llama3-8b")``, ``list_archs()``."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    ModelConfig,
    ShapeConfig,
    SHAPES,
    TRAIN_4K,
    PREFILL_32K,
    DECODE_32K,
    LONG_500K,
    reduced,
    smoke_shape,
)

_ARCH_MODULES = {
    "whisper-tiny": "whisper_tiny",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "llama3-8b": "llama3_8b",
    "qwen2-7b": "qwen2_7b",
    "phi3-mini-3.8b": "phi3_mini_38b",
    "gemma2-27b": "gemma2_27b",
    "internvl2-26b": "internvl2_26b",
    "mamba2-1.3b": "mamba2_13b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in list_archs()}


def cells(arch: str) -> List[ShapeConfig]:
    """Runnable (arch x shape) cells, honoring documented skips."""
    cfg = get_config(arch)
    return [s for s in SHAPES.values() if s.name not in cfg.skip_shapes]


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "TRAIN_4K", "PREFILL_32K",
    "DECODE_32K", "LONG_500K", "reduced", "smoke_shape", "get_config",
    "list_archs", "all_configs", "cells",
]
