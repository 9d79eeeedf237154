"""launches_per_tick.serve: device operations that start inside the
profiled steps' decode windows (the Tracer's ``decode_window`` spans, on
the profiler's clock), per decode tick; layer model (``models/*``, the
tick's ops).  Moves ``decode_tok_s``."""
from portbench.readers import profiled


def read(pl):
    tr = pl["trace"]
    steps = profiled(pl)
    if tr is None or tr.offset_ns is None or not steps:
        return None
    t0, t1 = steps[0].t0, steps[-1].t1
    wins = [s for s in pl["spans"] if s["name"] == "decode_window"
            and t0 <= s["t0"] <= t1]
    if not wins:
        return None
    n = sum(len(tr.ops("", tr.ns(s["t0"]), tr.ns(s["t1"]))) for s in wins)
    return n / (len(wins) * pl["ticks"]) if n else None
