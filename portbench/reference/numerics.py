"""The arithmetic of the reference's matrix products: float32 (the
reference), or every product's two operands rounded to float8 e4m3 first
(the control: the step below the configuration's bfloat16, with a scale a
row of the activations and a column of the weights, products summed in
float32)."""
from __future__ import annotations

import torch

FP8_MAX = 448.0      # largest finite float8 e4m3fn


def strict_f32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the absolute maximum maps to the largest finite value), back in x's
    type; the gradient passes straight through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


class Numerics:
    """``mm(x, w)``: x (..., n) @ w (n, m), in float32 or through fp8."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"numerics {kind!r} not in ('f32', 'fp8')")
        self.kind = kind

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.float(), w.float()
        if self.kind == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w
