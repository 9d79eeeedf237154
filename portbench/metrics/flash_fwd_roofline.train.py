"""flash_fwd_roofline.train: the share of its roofline that the flash
attention kernel (``csrc/flash_attention.cu``) reaches in the profiled
train steps; layer kernels.  Moves ``train_tok_s``.

Each launch attends one microbatch (batch / microbatches rows) of the
sequence length causally: 4 x H x hd flops over each row's S x (S + 1) / 2
pairs in one layer.  Launches are counted from the trace (the forward and
its recomputation under remat each need the forward's flops); at 989
TFLOP/s bf16 that is the least time, over the kernel's device time."""
from portbench.flops import causal_attention_flops
from portbench.peaks import BF16_FLOPS_PER_S

KERNEL = "flash_"


def read(pl):
    tr = pl["trace"]
    if tr is None:
        return None
    ops = tr.ops(KERNEL)
    seconds = sum(e - s for _, s, e, _ in ops) / 1e9
    if seconds <= 0:
        return None
    A, mix, wl = pl["arch"], pl["traffic"], pl["workload"]
    rows = mix["batch"] // wl["microbatches"]
    per_launch = rows * causal_attention_flops(A, mix["seq"], layers=1)
    return 100.0 * len(ops) * per_launch / BF16_FLOPS_PER_S / seconds
