"""flash_prefill_roofline.serve: the share of its roofline that the flash
attention kernel (``csrc/flash_attention.cu``) reaches in the profiled
steps' admission prefills; layer kernels.  Moves ``ttft_p95_ms``.

Flops the prompts need: causal attention over each admitted prompt's own
length (not the padded width the engine runs), Q.K^T and P.V over its
length x (length + 1) / 2 pairs, 4 x H x hd flops a pair, every layer; at
989 TFLOP/s bf16 that is the least time; over the kernel's device time."""
from portbench.flops import causal_attention_flops
from portbench.peaks import BF16_FLOPS_PER_S
from portbench.readers import admitted, profiled

KERNEL = "flash_"


def read(pl):
    tr = pl["trace"]
    if tr is None:
        return None
    seconds = tr.op_seconds(KERNEL)
    if seconds <= 0:
        return None
    A = pl["arch"]
    need = sum(causal_attention_flops(A, n) for n in admitted(profiled(pl)))
    return 100.0 * need / BF16_FLOPS_PER_S / seconds
