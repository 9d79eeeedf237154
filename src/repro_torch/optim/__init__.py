"""Optimizer, learning-rate schedules and the EF-int8 gradient compressor
(torch counterpart of ``repro/optim``)."""
from repro_torch.optim.adamw import AdamW, global_norm
from repro_torch.optim.compress import (CompressedOptimizer, apply_error_feedback,
                                        compressed_psum, compressed_psum_ef,
                                        dequantize, init_error_state, quantize,
                                        wrap_optimizer)
from repro_torch.optim.schedule import constant, warmup_cosine

__all__ = ["AdamW", "global_norm", "constant", "warmup_cosine",
           "CompressedOptimizer", "apply_error_feedback", "compressed_psum",
           "compressed_psum_ef", "dequantize", "init_error_state", "quantize",
           "wrap_optimizer"]
