"""device_idle.train: the share of the traced window in which no operation
ran on the device (the union of kernel, copy and set intervals from the
profiler's trace); layer device.  Moves ``train_tok_s``."""


def read(pl):
    tr = pl["trace"]
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
