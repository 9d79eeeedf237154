"""Public model API of the port: ``build_model(cfg) -> Model`` with
init/loss/prefill/decode_step, the ``StateBank`` contract, and serve
capability metadata (torch counterpart of ``repro/models/api.py``).

The dense decoder, moe (granite, moonshot), vlm (internvl2), ssm
(mamba2) and hybrid (recurrentgemma) families are ported for serving and
training (``mode="train"``, ``loss``); ``build_model`` raises
``UnsupportedFamilyError`` for any other (encdec).  ``input_specs`` /
``make_inputs`` give each shape cell's operands (the vlm family's
``vision_embeds`` too).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.common import (ParamDefs, Params, cross_entropy,
                                       materialize, torch_dtype)


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


BANK_KINDS = ("kv", "recurrent", "ring")


@dataclasses.dataclass(frozen=True)
class StateBank:
    """One named per-slot state bank of the decode cache.

    Every bank has its slot axis at ``batch_axis``; row b belongs to serve
    slot b alone.  ``kind`` fixes the lifecycle the engines apply:

    - ``"kv"``: positioned KV rows along ``seq_axis``.  Prefill scatters
      positions ``[0, len)`` of a slot's row; decode writes at the row's
      own position and reads are position-guarded, so stale entries of a
      freed slot are unreadable and need no reset.
    - ``"recurrent"``: positionless state (SSD conv/state, RG-LRU hidden
      state) that every decode step rewrites whole: the engine merges
      decode results under the active mask, prefills with a masked
      per-token scan, and resets the row when a slot is admitted or
      freed.
    - ``"ring"``: ring-buffer KV (and its ``pos`` bank) wrapping modulo
      the window; treated like ``"recurrent"``, and reads honour the
      ``pos >= 0`` empty-slot guard.

    Banks with a ``seq_axis`` have ``batch_axis < seq_axis``.
    """

    name: str
    kind: str
    batch_axis: int
    seq_axis: Optional[int] = None

    def __post_init__(self):
        if self.kind not in BANK_KINDS:
            raise ValueError(f"unknown bank kind {self.kind!r} (the port "
                             f"serves {', '.join(BANK_KINDS)})")
        if self.seq_axis is not None and self.batch_axis >= self.seq_axis:
            raise ValueError(
                f"bank {self.name!r}: batch_axis {self.batch_axis} must "
                f"precede seq_axis {self.seq_axis}")


# Which serve engines can host each family: "dense" = Engine /
# EngineReference slot caches, "paged" = PagedEngine page pools (positioned
# KV rows only, so not the recurrent families).  encdec comes in a later
# slice.
_FAMILY_SERVE_MODES: Dict[str, frozenset] = {
    "dense": frozenset({"dense", "paged"}),
    "moe": frozenset({"dense", "paged"}),
    "vlm": frozenset({"dense", "paged"}),
    "ssm": frozenset({"dense"}),
    "hybrid": frozenset({"dense"}),
}


_TRAIN_FAMILIES = frozenset(_FAMILY_SERVE_MODES)


def serve_families(mode: str):
    """Families servable under engine ``mode`` ("dense" | "paged")."""
    return tuple(sorted(f for f, m in _FAMILY_SERVE_MODES.items()
                        if mode in m))


def check_trainable(cfg: ModelConfig, component: str) -> None:
    """Raise ``UnsupportedFamilyError`` unless the port trains ``cfg``'s
    family."""
    if cfg.family not in _TRAIN_FAMILIES:
        raise UnsupportedFamilyError(
            cfg.family, _TRAIN_FAMILIES, component,
            detail="the encdec family is not ported yet")


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
    def forward(self, params: Params, batch: Dict[str, torch.Tensor], *,
                mode: str, cache: Optional[Params] = None,
                cache_pos: Optional[torch.Tensor] = None,
                attn_impl: str = "plain",
                page_table: Optional[torch.Tensor] = None,
                kv_write_mask: Optional[torch.Tensor] = None,
                logits_at: Optional[torch.Tensor] = None):
        """Dispatch per family: the hybrid stack, or the decoder (dense,
        moe, vlm and ssm; ``batch["vision_embeds"]`` reaches the vlm
        embedding).  Returns (logits, cache, aux): ``mode="train"`` gives
        (B, S, V) f32 logits under autograd and no cache; ``aux`` is the
        MoE load-balancing loss in train mode, else None."""
        cfg = self.cfg
        if mode == "train":
            check_trainable(cfg, "repro_torch training")
        if cfg.family in ("ssm", "hybrid") and page_table is not None:
            raise ValueError("paged KV serving requires a dense decoder "
                             f"({cfg.family} has recurrent state)")
        if cfg.family == "hybrid":
            return tf.hybrid_forward(cfg, params, batch["tokens"], mode=mode,
                                     cache=cache, cache_pos=cache_pos,
                                     attn_impl=attn_impl,
                                     logits_at=logits_at) + (None,)
        return tf.decoder_forward(cfg, params, batch["tokens"], mode=mode,
                                  cache=cache, cache_pos=cache_pos,
                                  attn_impl=attn_impl, logits_at=logits_at,
                                  page_table=page_table,
                                  kv_write_mask=kv_write_mask,
                                  vision_embeds=batch.get("vision_embeds"))

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], *,
             attn_impl: str = "kernel") -> torch.Tensor:
        """Mean next-token cross-entropy of ``batch["tokens"]`` against
        ``batch["labels"]`` (both (B, S) int), plus the MoE aux loss (moe
        family), differentiable, as ``repro.models.api.Model.loss``.  A vlm
        batch may carry ``vision_embeds`` (B, Nv, D).
        ``attn_impl="kernel"`` attends through the flash kernel and scans
        through the SSD and RG-LRU kernels under autograd (their plain
        versions on CPU tensors), ``"plain"`` through naive attention and
        the plain RG-LRU scan."""
        logits, _, aux = self.forward(params, batch, mode="train",
                                      attn_impl=attn_impl)
        loss = cross_entropy(logits, batch["labels"], self.cfg.final_softcap)
        return loss if aux is None else loss + aux

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], *,
                logits_at: Optional[torch.Tensor] = None):
        """Full-prompt forward: (logits, fresh cache) — the stacked KV
        (dense), or the recurrent state and ring caches after the prompt
        (ssm, hybrid), whose sequence scans run through ``ops.ssd_scan``
        and ``ops.rglru_scan`` (the CUDA kernels on CUDA tensors).  A vlm
        batch may carry ``vision_embeds`` (B, Nv, D)."""
        logits, cache, _ = self.forward(params, batch, mode="prefill",
                                        attn_impl="kernel",
                                        logits_at=logits_at)
        return logits, cache

    def decode_step(self, params: Params, cache: Params,
                    batch: Dict[str, torch.Tensor], pos: torch.Tensor, *,
                    attn_impl: str = "plain",
                    page_table: Optional[torch.Tensor] = None,
                    kv_write_mask: Optional[torch.Tensor] = None,
                    logits_at: Optional[torch.Tensor] = None):
        """One decode step at per-row positions ``pos`` (B,) int32; returns
        (logits (B,1,V), cache).  The dense cache is updated in place and
        returned; the ssm/hybrid caches come back as new tensors, the cache
        passed in keeping its bits.  ``attn_impl`` selects the tick's
        kernels (attention; the RG-LRU scan of the hybrid family).

        With ``page_table`` (B, nb) the cache is the paged pool and ``pos``
        each row's first write position; S > 1 tokens per row is the paged
        suffix prefill (writes masked by ``kv_write_mask``), returning
        (B, S, V) logits, or (B, 1, V) at token index ``logits_at[b]``."""
        logits, cache, _ = self.forward(
            params, batch, mode="decode", cache=cache, cache_pos=pos,
            attn_impl=attn_impl, page_table=page_table,
            kv_write_mask=kv_write_mask, logits_at=logits_at)
        return logits, cache

    # ---- serve capability metadata -------------------------------------
    @property
    def serve_modes(self) -> frozenset:
        """``"dense"`` = Engine / EngineReference, ``"paged"`` =
        PagedEngine."""
        return _FAMILY_SERVE_MODES[self.cfg.family]

    def state_banks(self) -> Dict[str, StateBank]:
        """The slot-state banks, keyed exactly like ``cache_defs``."""
        if self.cfg.family == "ssm":
            return {n: StateBank(n, "recurrent", batch_axis=1)
                    for n in ("conv", "ssm")}
        if self.cfg.family == "hybrid":
            banks = {n: StateBank(n, "recurrent", batch_axis=1)
                     for n in ("rec/h", "rec/conv")}
            for n in ("attn/k", "attn/v", "attn/pos"):
                banks[n] = StateBank(n, "ring", batch_axis=1, seq_axis=2)
            return banks
        return {n: StateBank(n, "kv", batch_axis=1, seq_axis=2)
                for n in ("k", "v")}


def build_model(cfg: ModelConfig, max_seq: int = 4096,
                device: DeviceLike = None) -> Model:
    """The port's model for ``cfg`` on ``device`` (CUDA unless the caller
    passes ``device="cpu"``)."""
    if cfg.family not in _FAMILY_SERVE_MODES:
        raise UnsupportedFamilyError(
            cfg.family, _FAMILY_SERVE_MODES, "repro_torch.build_model",
            detail="the encdec family is not ported yet")
    if not cfg.scan_layers and cfg.family != "hybrid":
        raise ValueError("the port keeps dense, moe, vlm and ssm layers "
                         "stacked (scan_layers=True)")
    return Model(cfg=cfg, max_seq=max_seq,
                 param_defs=tf.model_param_defs(cfg),
                 device=resolve_device(device))


# ---------------------------------------------------------------------------
# input specs (each shape cell's operands)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one (arch x shape) cell's operands, as
    ``repro.models.api.input_specs`` gives them for the families the port
    builds: train -> tokens, labels; prefill -> tokens; decode -> tokens
    (B, 1) (the cache comes from ``Model.cache_defs``); the vlm family's
    train and prefill cells add ``vision_embeds`` (B, vision_tokens, D)
    in the model dtype."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        return {"tokens": ((B, 1), i32)}
    specs = {"tokens": ((B, S), i32)}
    if shape.kind == "train":
        specs["labels"] = ((B, S), i32)
    if cfg.family == "vlm":
        specs["vision_embeds"] = ((B, cfg.vision_tokens, cfg.d_model),
                                  torch_dtype(cfg.dtype))
    return specs


def make_inputs(cfg: ModelConfig, shape: ShapeConfig,
                generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Random operands matching ``input_specs``, drawn from ``generator``
    (on its own device) in the specs' order: uniform tokens in [0, vocab)
    and standard normal embeddings (drawn in f32, then cast)."""
    dev = resolve_device(device)
    out = {}
    for name, (shp, dt) in input_specs(cfg, shape).items():
        if dt == torch.int32:
            t = torch.randint(0, cfg.vocab_size, shp, generator=generator,
                              device=generator.device, dtype=torch.int64)
        else:
            t = torch.randn(shp, generator=generator,
                            device=generator.device, dtype=torch.float32)
        out[name] = t.to(device=dev, dtype=dt)
    return out
