"""prefill_call_ms.serve: the mean host-observed span of the engine's
batched admission prefills (the Tracer's ``prefill P=<padded length>``),
over the window's steps after the profiled ones; layer engine
(``serve/engine.py``).  Moves ``ttft_p95_ms``."""
from statistics import mean

from portbench.readers import spans_after_profiling


def read(pl):
    spans = spans_after_profiling(pl, "prefill P=")
    if not spans:
        return None
    return mean((s["t1"] - s["t0"]) * 1e3 for s in spans)
