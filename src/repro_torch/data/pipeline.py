"""Deterministic synthetic LM data pipeline (torch counterpart of
``repro/data/pipeline.py``).

Token streams come from a uint32 counter hash (lowbias32-style avalanche)
of (seed, step, host, index), with a log-uniform-ish marginal.  The host
path (``_tokens_at`` / ``_batch_at``, numpy uint32 with wrap-around
multiply) is a copy of the JAX package's.  ``device_batch_at`` is its
bitwise twin in torch on any device, from a step that may be a device
tensor: CUDA has no uint32 multiply in torch, so it computes in int64 and
keeps the low 32 bits after every step, multiplying by each 32-bit
constant in two 16-bit halves so that no product leaves int64.  The fused
train window hashes its batches on the card this way while the per-step
oracle consumes the same tokens from ``Pipeline``.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

# lowbias32 avalanche constants (Hash Prospector) + fold/stream salts
_MIX_A = 0x7FEB352D
_MIX_B = 0x846CA68B
_GOLDEN = 0x9E3779B9
_SALT_SHIFT = 0x85EBCA6B
_LOW32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError(f"global batch {self.global_batch} not "
                             f"divisible by {self.num_hosts} hosts")
        return self.global_batch // self.num_hosts


# ---- host path (numpy uint32) ----------------------------------------------


def _mix32(x):
    """32-bit avalanche under numpy uint32 wrap semantics."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(_MIX_A)
    x = x ^ (x >> np.uint32(15))
    x = x * np.uint32(_MIX_B)
    x = x ^ (x >> np.uint32(16))
    return x


def _tokens_at(seed, step, host_id, host_batch: int, seq_len: int,
               vocab_size: int) -> np.ndarray:
    """(host_batch, seq_len + 1) int32 token grid for one (seed, step,
    host).  Marginal: ``(h1 % vocab) >> (h2 & 15)``."""
    n = host_batch * (seq_len + 1)
    base = np.full((1,), _GOLDEN, dtype=np.uint32)
    base = _mix32(base ^ np.asarray(seed).astype(np.uint32))
    base = _mix32(base ^ np.asarray(step).astype(np.uint32))
    base = _mix32(base ^ np.asarray(host_id).astype(np.uint32))
    idx = np.arange(n, dtype=np.uint32)
    h1 = _mix32(idx ^ base)
    h2 = _mix32(h1 ^ np.uint32(_SALT_SHIFT))
    tok = (h1 % np.uint32(vocab_size)) >> (h2 & np.uint32(15))
    return tok.astype(np.int32).reshape(host_batch, seq_len + 1)


def _batch_at(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Deterministic batch for (seed, step, host). Heavy-tailed tokens."""
    tokens = _tokens_at(cfg.seed, step, cfg.host_id, cfg.host_batch,
                        cfg.seq_len, cfg.vocab_size)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def batch_for_step(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    """Random access (used by restarts and tests)."""
    return _batch_at(cfg, step)


# ---- device path (torch int64 holding uint32 values) -----------------------


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for uint32 values x held in int64: the product
    with c's low and high 16 bits separately, each below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _LOW32


def _mix32_t(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX_A)
    x = x ^ (x >> 15)
    x = _mul32(x, _MIX_B)
    return x ^ (x >> 16)


def device_batch_at(cfg: DataConfig, step,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """Bitwise twin of ``_batch_at`` in torch.  ``step`` is an int or a
    0-d integer tensor (the train state's step: then no host sync, and the
    batch is made on its device unless ``device`` is given).  Returns
    int32 ``tokens`` and ``labels`` (host_batch, seq_len)."""
    if isinstance(step, torch.Tensor):
        device = step.device if device is None else device
        step_t = step.to(device=device, dtype=torch.int64) & _LOW32
    else:
        step_t = torch.tensor(int(step) & _LOW32, dtype=torch.int64,
                              device=device)
    hb, S = cfg.host_batch, cfg.seq_len
    base = torch.full((1,), _GOLDEN, dtype=torch.int64, device=device)
    base = _mix32_t(base ^ (cfg.seed & _LOW32))
    base = _mix32_t(base ^ step_t)
    base = _mix32_t(base ^ (cfg.host_id & _LOW32))
    idx = torch.arange(hb * (S + 1), dtype=torch.int64, device=device)
    h1 = _mix32_t(idx ^ base)
    h2 = _mix32_t(h1 ^ _SALT_SHIFT)
    tok = ((h1 % cfg.vocab_size) >> (h2 & 15)).to(torch.int32)
    tok = tok.reshape(hb, S + 1)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


class Pipeline:
    """Prefetching iterator of host batches with a checkpointable
    position: a daemon thread makes batches ``start_step, start_step + 1,
    ...`` ahead into a bounded queue."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        step = self._step
        while not self._stop.is_set():
            batch = _batch_at(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        step, batch = self._q.get()
        self._step = step + 1
        return batch

    @property
    def state(self) -> Dict[str, int]:
        """Checkpointable position (next step to consume)."""
        return {"step": self._step}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
