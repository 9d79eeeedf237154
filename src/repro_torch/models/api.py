"""Public model API of the port: ``build_model(cfg) -> Model`` with
init/prefill/decode_step, the kv-only ``StateBank`` contract, and serve
capability metadata (torch counterpart of ``repro/models/api.py``).

Only the dense decoder family is ported; ``build_model`` raises
``UnsupportedFamilyError`` for any other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import ParamDefs, Params, materialize


class UnsupportedFamilyError(ValueError):
    """Raised when a model family is asked of a component that cannot serve
    it, naming the family and the supported set."""

    def __init__(self, family: str, supported, component: str,
                 detail: str = ""):
        self.family = family
        self.supported = tuple(sorted(supported))
        msg = (f"{component} does not support model family {family!r} "
               f"(supported families: {', '.join(self.supported)})")
        if detail:
            msg += f"; {detail}"
        super().__init__(msg)


@dataclasses.dataclass(frozen=True)
class StateBank:
    """One named per-slot state bank of the decode cache.

    The port serves KV banks only: a ``"kv"`` bank has its slot axis at
    ``batch_axis`` and positioned rows along ``seq_axis``.  Prefill
    scatters positions ``[0, len)`` of a slot's row; decode writes at the
    row's own position and reads are position-guarded, so stale entries of
    a freed slot are unreadable and need no reset.
    """

    name: str
    kind: str
    batch_axis: int
    seq_axis: int

    def __post_init__(self):
        if self.kind != "kv":
            raise ValueError(f"bank kind {self.kind!r}: the port serves "
                             "'kv' banks only")
        if self.batch_axis >= self.seq_axis:
            raise ValueError(
                f"bank {self.name!r}: batch_axis {self.batch_axis} must "
                f"precede seq_axis {self.seq_axis}")


# Which serve engines can host each family: "dense" = Engine /
# EngineReference slot caches, "paged" = PagedEngine page pools.  Other
# families come in later slices.
_FAMILY_SERVE_MODES: Dict[str, frozenset] = {
    "dense": frozenset({"dense", "paged"})}


def serve_families(mode: str):
    """Families servable under engine ``mode`` ("dense" | "paged")."""
    return tuple(sorted(f for f, m in _FAMILY_SERVE_MODES.items()
                        if mode in m))


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    max_seq: int
    param_defs: ParamDefs
    device: torch.device

    # ---- params ---------------------------------------------------------
    def init(self, generator: torch.Generator) -> Params:
        """Random weights by the JAX package's init rules, drawn from
        ``generator`` (on its own device) and placed on ``self.device``."""
        return materialize(self.param_defs, generator, self.cfg.dtype,
                           self.device)

    # ---- cache ----------------------------------------------------------
    def cache_defs(self, batch: int, max_len: int) -> ParamDefs:
        return tf.cache_param_defs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int) -> Params:
        return materialize(self.cache_defs(batch, max_len), None,
                           self.cfg.dtype, self.device)

    # ---- paged cache (serve) --------------------------------------------
    def paged_cache_defs(self, num_pages: int, page_size: int) -> ParamDefs:
        """Per-layer physical page pools; ``num_pages`` includes the
        trailing TRASH page."""
        return tf.paged_cache_param_defs(self.cfg, num_pages, page_size)

    def init_paged_cache(self, num_pages: int, page_size: int) -> Params:
        return materialize(self.paged_cache_defs(num_pages, page_size),
                           None, self.cfg.dtype, self.device)

    # ---- forward --------------------------------------------------------
    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], *,
                logits_at: Optional[torch.Tensor] = None):
        """Full-prompt forward: (logits, fresh stacked KV cache)."""
        return tf.decoder_forward(self.cfg, params, batch["tokens"],
                                  mode="prefill", logits_at=logits_at)

    def decode_step(self, params: Params, cache: Params,
                    batch: Dict[str, torch.Tensor], pos: torch.Tensor, *,
                    attn_impl: str = "plain",
                    page_table: Optional[torch.Tensor] = None,
                    kv_write_mask: Optional[torch.Tensor] = None,
                    logits_at: Optional[torch.Tensor] = None):
        """One decode step at per-row positions ``pos`` (B,) int32.  The
        cache is updated in place; returns (logits (B,1,V), cache).

        With ``page_table`` (B, nb) the cache is the paged pool and ``pos``
        each row's first write position; S > 1 tokens per row is the paged
        suffix prefill (writes masked by ``kv_write_mask``), returning
        (B, S, V) logits, or (B, 1, V) at token index ``logits_at[b]``."""
        return tf.decoder_forward(self.cfg, params, batch["tokens"],
                                  mode="decode", cache=cache, cache_pos=pos,
                                  attn_impl=attn_impl, logits_at=logits_at,
                                  page_table=page_table,
                                  kv_write_mask=kv_write_mask)

    # ---- serve capability metadata -------------------------------------
    @property
    def serve_modes(self) -> frozenset:
        """``"dense"`` = Engine / EngineReference, ``"paged"`` =
        PagedEngine."""
        return _FAMILY_SERVE_MODES[self.cfg.family]

    def state_banks(self) -> Dict[str, StateBank]:
        """The slot-state banks, keyed exactly like ``cache_defs``."""
        return {n: StateBank(n, "kv", batch_axis=1, seq_axis=2)
                for n in ("k", "v")}


def build_model(cfg: ModelConfig, max_seq: int = 4096,
                device: DeviceLike = None) -> Model:
    """The port's model for ``cfg`` on ``device`` (CUDA unless the caller
    passes ``device="cpu"``)."""
    if cfg.family not in _FAMILY_SERVE_MODES:
        raise UnsupportedFamilyError(
            cfg.family, _FAMILY_SERVE_MODES, "repro_torch.build_model",
            detail="only the dense decoder is ported so far")
    if not cfg.scan_layers:
        raise ValueError("the port keeps layers stacked (scan_layers=True)")
    return Model(cfg=cfg, max_seq=max_seq,
                 param_defs=tf.model_param_defs(cfg),
                 device=resolve_device(device))
