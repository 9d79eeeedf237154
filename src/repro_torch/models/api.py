"""Public model API of the port: ``build_model(cfg) -> Model`` with
init/loss/prefill/decode_step, the ``StateBank`` contract, and serve
capability metadata (torch counterpart of ``repro/models/api.py``).

The dense decoder, moe (granite, moonshot), vlm (internvl2), ssm
(mamba2), hybrid (recurrentgemma) and encdec (whisper) families are
ported for serving and training (``mode="train"``, ``loss``; an encdec
batch may carry ``frames``, and without them its decoder trains with no
cross-attention, as JAX's); ``build_model`` raises
``UnsupportedFamilyError`` for any other family.  ``input_specs`` /
``make_inputs`` give each shape cell's operands (the vlm family's
``vision_embeds``, the encdec family's ``frames`` and ``enc_out`` too).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ATTN_IMPLS
from repro_torch.models.common import (Axes, ParamDefs, Params, abstract,
                                       axes_of, cross_entropy, materialize,
                                       torch_dtype)

# encoder frames of the encdec family's decode cells (the encoder runs once
# at prefill; decode attends its output)
WHISPER_DECODE_ENC_LEN = 1536


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


BANK_KINDS = ("kv", "recurrent", "ring", "enc")


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
    - ``"enc"``: the encoder output of a slot's request (whisper's
      cross-attention source), written whole at admission and passed
      through decode unchanged; not guarded: the next admission into the
      slot overwrites the row.

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
# KV rows only, so not the recurrent families nor the encoder bank).
_FAMILY_SERVE_MODES: Dict[str, frozenset] = {
    "dense": frozenset({"dense", "paged"}),
    "moe": frozenset({"dense", "paged"}),
    "vlm": frozenset({"dense", "paged"}),
    "ssm": frozenset({"dense"}),
    "hybrid": frozenset({"dense"}),
    "encdec": frozenset({"dense"}),
}


# the families that no page table serves, and the state that keeps them out
_UNPAGED_STATE = {"ssm": "recurrent state", "hybrid": "recurrent state",
                  "encdec": "an encoder-output bank"}


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

    def abstract_params(self) -> Params:
        """``meta`` stand-ins of the weights (the dry run's; nothing is
        allocated)."""
        return abstract(self.param_defs, self.cfg.dtype)

    def param_axes(self) -> Axes:
        return axes_of(self.param_defs)

    # ---- cache ----------------------------------------------------------
    def cache_defs(self, batch: int, max_len: int) -> ParamDefs:
        return tf.cache_param_defs(self.cfg, batch, max_len)

    def init_cache(self, batch: int, max_len: int) -> Params:
        return materialize(self.cache_defs(batch, max_len), None,
                           self.cfg.dtype, self.device)

    def abstract_cache(self, batch: int, max_len: int) -> Params:
        return abstract(self.cache_defs(batch, max_len), self.cfg.dtype)

    def cache_axes(self, batch: int, max_len: int) -> Axes:
        return axes_of(self.cache_defs(batch, max_len))

    # ---- paged cache (serve) --------------------------------------------
    def paged_cache_defs(self, num_pages: int, page_size: int) -> ParamDefs:
        """Per-layer physical page pools; ``num_pages`` includes the
        trailing TRASH page."""
        return tf.paged_cache_param_defs(self.cfg, num_pages, page_size)

    def init_paged_cache(self, num_pages: int, page_size: int) -> Params:
        return materialize(self.paged_cache_defs(num_pages, page_size),
                           None, self.cfg.dtype, self.device)

    def paged_cache_axes(self, num_pages: int, page_size: int) -> Axes:
        return axes_of(self.paged_cache_defs(num_pages, page_size))

    # ---- forward --------------------------------------------------------
    def forward(self, params: Params, batch: Dict[str, torch.Tensor], *,
                mode: str, cache: Optional[Params] = None,
                cache_pos=None,
                attn_impl: str = "plain",
                page_table: Optional[torch.Tensor] = None,
                kv_write_mask: Optional[torch.Tensor] = None,
                logits_at: Optional[torch.Tensor] = None):
        """Dispatch per family: the encoder-decoder (``batch["frames"]``
        or ``batch["enc_out"]`` reach it, in every mode), the hybrid
        stack, or the decoder
        (dense, moe, vlm and ssm; ``batch["vision_embeds"]`` reaches the
        vlm embedding).  Returns (logits, cache, aux): ``mode="train"``
        gives (B, S, V) f32 logits under autograd and no cache; ``aux`` is
        the MoE load-balancing loss in train mode, else None."""
        cfg = self.cfg
        if cfg.family in _UNPAGED_STATE and page_table is not None:
            raise ValueError("paged KV serving requires a dense decoder "
                             f"({cfg.family} has "
                             f"{_UNPAGED_STATE[cfg.family]})")
        if cfg.family == "encdec":
            return tf.encdec_forward(
                cfg, params, batch["tokens"], frames=batch.get("frames"),
                enc_out=batch.get("enc_out"), mode=mode, cache=cache,
                cache_pos=cache_pos, attn_impl=attn_impl,
                logits_at=logits_at) + (None,)
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
        batch may carry ``vision_embeds`` (B, Nv, D), an encdec batch
        ``frames`` (B, Se, D) (the encoder runs under autograd; without
        them the decoder has no cross-attention, and the ``xattn/*`` and
        ``lnx/*`` weights get no gradient).
        ``attn_impl="kernel"`` attends through the flash kernel and scans
        through the SSD and RG-LRU kernels under autograd (their plain
        versions on CPU tensors), ``"plain"`` through naive attention and
        the plain RG-LRU scan."""
        logits, _, aux = self.forward(params, batch, mode="train",
                                      attn_impl=attn_impl)
        loss = cross_entropy(logits, batch["labels"], self.cfg.final_softcap)
        return loss if aux is None else loss + aux

    def prefill(self, params: Params, batch: Dict[str, torch.Tensor], *,
                logits_at: Optional[torch.Tensor] = None,
                attn_impl: str = "kernel"):
        """Full-prompt forward: (logits, fresh cache) — the stacked KV
        (dense), or the recurrent state and ring caches after the prompt
        (ssm, hybrid), whose sequence scans run through ``ops.ssd_scan``
        and ``ops.rglru_scan`` (the CUDA kernels on CUDA tensors) whatever
        ``attn_impl`` says.  ``attn_impl`` selects the attention route only
        (``attention.ATTN_IMPLS``): "kernel" (the default, as JAX's
        "chunked") the flash kernel, "plain" naive attention (JAX's
        "naive"), "kernel_bf16" the flash kernel with bf16 probabilities.
        A vlm batch may carry ``vision_embeds`` (B, Nv, D); an encdec batch
        carries ``frames`` (B, Se, D) (the encoder runs first, by the same
        route) or ``enc_out`` (B, Se, D), and its cache holds no
        ``enc/out`` (the engines write that bank)."""
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        logits, cache, _ = self.forward(params, batch, mode="prefill",
                                        attn_impl=attn_impl,
                                        logits_at=logits_at)
        return logits, cache

    def decode_step(self, params: Params, cache: Params,
                    batch: Dict[str, torch.Tensor], pos, *,
                    attn_impl: str = "plain",
                    page_table: Optional[torch.Tensor] = None,
                    kv_write_mask: Optional[torch.Tensor] = None,
                    logits_at: Optional[torch.Tensor] = None):
        """One decode step at per-row positions ``pos`` (B,) int32 (the
        serve tick: every slot at its own depth), or at one scalar
        position ``pos`` (an int or a 0-d tensor, read once a step) for
        the whole batch, the dry-run and test convention of JAX's
        ``decode_step``; returns (logits (B,1,V), cache).  The dense cache
        is updated in place and returned; the ssm/hybrid caches come back
        as new tensors, the cache passed in keeping its bits.
        ``attn_impl`` selects the tick's kernels (attention; the RG-LRU
        scan of the hybrid family): at vector positions "plain" or
        "kernel" (the fused decode kernel), at a scalar position on the
        dense cache one of ``attention.ATTN_IMPLS`` ("kernel": the flash
        kernel with ``q_offset = pos``, ``kv_len = pos + 1``); the hybrid
        family's scalar ring attention is naive, as in JAX.  The encdec
        family's cross-attention reads ``batch["enc_out"]`` when given,
        else the cache's ``enc/out`` bank, and takes ``attn_impl`` too
        ("kernel": the flash kernel).

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
        if self.cfg.family == "encdec":
            banks = {}
            for i in range(self.cfg.dec_layers):
                for n in (f"dec_{i}/k", f"dec_{i}/v"):
                    banks[n] = StateBank(n, "kv", batch_axis=0, seq_axis=1)
            banks["enc/out"] = StateBank("enc/out", "enc", batch_axis=0)
            return banks
        return {n: StateBank(n, "kv", batch_axis=1, seq_axis=2)
                for n in ("k", "v")}

    def encode_prompt(self, params: Params, tokens: torch.Tensor,
                      lens: torch.Tensor) -> torch.Tensor:
        """The encoder over stub frames made from the prompt tokens
        (whisper's conv frontend is a stub: frames are the token
        embeddings, zeroed at and past ``lens[b]``).  tokens (B, Se)
        right-padded, lens (B,) -> (B, Se, D) for the ``enc/out`` bank.
        The encoder attends through the flash kernel, as JAX's fixed
        encoder program uses "chunked".

        The encoder is bidirectional with no padding mask, so its output
        depends on the padded length Se, and a library matmul may pick
        its algorithm by shape: the serve engines call it at one fixed
        shape (slots, max_len), so that a row's output is the same bits
        in every admission wave and in both engines."""
        if self.cfg.family != "encdec":
            raise ValueError(f"encode_prompt is encdec-only (family "
                             f"{self.cfg.family!r})")
        emb = params["emb/tok"][tokens].to(torch_dtype(self.cfg.dtype))
        live = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
                < lens[:, None])
        return tf.encoder_forward(self.cfg, params,
                                  emb * live[:, :, None].to(emb.dtype),
                                  "kernel")


def build_model(cfg: ModelConfig, max_seq: int = 4096,
                device: DeviceLike = None) -> Model:
    """The port's model for ``cfg`` on ``device`` (CUDA unless the caller
    passes ``device="cpu"``)."""
    if cfg.family not in _FAMILY_SERVE_MODES:
        raise UnsupportedFamilyError(
            cfg.family, _FAMILY_SERVE_MODES, "repro_torch.build_model")
    if not cfg.scan_layers and cfg.family not in ("hybrid", "encdec"):
        raise ValueError("the port keeps dense, moe, vlm and ssm layers "
                         "stacked (scan_layers=True)")
    return Model(cfg=cfg, max_seq=max_seq,
                 param_defs=tf.model_param_defs(cfg, max_seq),
                 device=resolve_device(device))


# ---------------------------------------------------------------------------
# input specs (each shape cell's operands)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``{name: (shape, dtype)}`` of one (arch x shape) cell's operands, as
    ``repro.models.api.input_specs`` gives them: train -> tokens, labels;
    prefill -> tokens; decode -> tokens (B, 1) (the cache comes from
    ``Model.cache_defs``); the vlm family's train and prefill cells add
    ``vision_embeds`` (B, vision_tokens, D), the encdec family's ``frames``
    (B, S, D), and its decode cells ``enc_out`` (B,
    ``WHISPER_DECODE_ENC_LEN``, D), all in the model dtype."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    dt = torch_dtype(cfg.dtype)
    if shape.kind == "decode":
        specs = {"tokens": ((B, 1), i32)}
        if cfg.family == "encdec":
            specs["enc_out"] = ((B, WHISPER_DECODE_ENC_LEN, cfg.d_model), dt)
        return specs
    specs = {"tokens": ((B, S), i32)}
    if shape.kind == "train":
        specs["labels"] = ((B, S), i32)
    if cfg.family == "encdec":
        specs["frames"] = ((B, S, cfg.d_model), dt)
    if cfg.family == "vlm":
        specs["vision_embeds"] = ((B, cfg.vision_tokens, cfg.d_model), dt)
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
