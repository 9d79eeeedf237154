"""Deterministic synthetic LM data (torch counterpart of ``repro/data``)."""
from repro_torch.data.pipeline import (DataConfig, Pipeline, batch_for_step,
                                       device_batch_at)

__all__ = ["DataConfig", "Pipeline", "batch_for_step", "device_batch_at"]
