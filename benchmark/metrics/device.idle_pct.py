"""device.idle_pct: the share of the traced calls' span in which no
device event ran, 100 x (1 - busy / span), busy the union of the device
events (profile_rank.py's arithmetic; the profiler's own host overhead
makes it an upper bound)."""
from benchmark import tracing


def read(rec):
    w = tracing.window(rec)
    if w is None or not rec["kernels"] or w[1] <= w[0]:
        return None
    return 100.0 * (1.0 - tracing.busy_us(rec) / (w[1] - w[0]))
