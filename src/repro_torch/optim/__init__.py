"""Optimizer and learning-rate schedules (torch counterpart of
``repro/optim``, without the EF-int8 gradient compressor)."""
from repro_torch.optim.adamw import AdamW, global_norm
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamW", "global_norm", "constant", "warmup_cosine"]
