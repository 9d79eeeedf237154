"""launches_per_step.train: device operations in the profiled window
calls, per train step; layer trainer (``train/trainer.py``).  Moves
``train_tok_s``."""
from portbench.readers import profiled


def read(pl):
    tr = pl["trace"]
    calls = profiled(pl)
    if tr is None or not calls:
        return None
    n = len(tr.ops())
    return n / sum(c["steps"] for c in calls) if n else None
