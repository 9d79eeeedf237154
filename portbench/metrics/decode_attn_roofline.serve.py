"""decode_attn_roofline.serve: the share of its roofline that the decode
attention kernel (``csrc/decode_attention.cu``) reaches in the profiled
steps; layer kernels.  Moves ``decode_tok_s``.

Bytes a call needs, per layer and tick, for each request it decodes: the
live K and V rows (prompt + tokens so far, the new row among them), the
new K and V row read from the projection, q read and the output written
(bf16): (rows + 1) x 2 x K x hd x 2 + 2 x H x hd x 2.  At the H100's 3.35
TB/s that is the least time; over the kernel's device time in the trace.
Slots that decode nothing (free, or finished) need nothing."""
from portbench.peaks import HBM_BYTES_PER_S
from portbench.readers import decode_rows, profiled

KERNEL = "decode_attention"


def call_bytes(arch, rows):
    kv_row = 2 * arch["K"] * arch["hd"] * 2
    q_out = 2 * arch["H"] * arch["hd"] * 2
    return sum((r + 1) * kv_row + q_out for r in rows)


def read(pl):
    tr = pl["trace"]
    if tr is None:
        return None
    seconds = tr.op_seconds(KERNEL)
    if seconds <= 0:
        return None
    A = pl["arch"]
    need = sum(call_bytes(A, rows) for rows in decode_rows(profiled(pl)))
    return 100.0 * A["L"] * need / HBM_BYTES_PER_S / seconds
