"""serve_mfu: model flops of the prompt and output tokens the window's
unprofiled steps served (``flops.serve_flops``: 2 x the matrix parameters
a token multiplies through, the head once an output token, causal
attention at each position), over those steps' host seconds at 989
TFLOP/s bf16; layer device.  Moves ``decode_tok_s``."""
from portbench.flops import serve_flops
from portbench.peaks import BF16_FLOPS_PER_S
from portbench.readers import unprofiled


def read(pl):
    steps, seconds = unprofiled(pl)
    if seconds <= 0:
        return None
    A = pl["arch"]
    work = sum(serve_flops(A, plen, old, new)
               for st in steps for plen, old, new in st.work)
    return 100.0 * work / (seconds * BF16_FLOPS_PER_S)
