"""decode_window_ms.serve: the mean host-observed span of the engine's
decode windows (the Tracer's ``decode_window``: launch to the drain's one
transfer back), over the window's steps after the profiled ones; layer
engine (``serve/engine.py``).  Moves ``decode_tok_s``."""
from statistics import mean

from portbench.readers import spans_after_profiling


def read(pl):
    spans = spans_after_profiling(pl, "decode_window")
    if not spans:
        return None
    return mean((s["t1"] - s["t0"]) * 1e3 for s in spans)
