"""prefill_mfu.serve: model flops of the prompts admitted in the window's
unprofiled steps (each prompt through every layer with its causal
attention, and the head once for its first token) over the seconds of
those steps' admission prefills (the Tracer's ``prefill P=`` spans) at
989 TFLOP/s bf16: the whole admission call's share of the chip's peak,
beside ``flash_prefill_roofline.serve``; layer device.  Moves
``ttft_p95_ms``."""
from portbench.flops import serve_flops
from portbench.peaks import BF16_FLOPS_PER_S
from portbench.readers import admitted, spans_after_profiling, unprofiled


def read(pl):
    steps, _ = unprofiled(pl)
    spans = spans_after_profiling(pl, "prefill P=")
    seconds = sum(s["t1"] - s["t0"] for s in spans)
    if not steps or seconds <= 0:
        return None
    A = pl["arch"]
    work = sum(serve_flops(A, n, 0, 1) for n in admitted(steps))
    return 100.0 * work / (seconds * BF16_FLOPS_PER_S)
