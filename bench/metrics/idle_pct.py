"""``idle_pct``: the share of the profiled call in which no device
operation ran (the union of kernel, copy and memset intervals from the
profiler's trace)."""


def read(run):
    prof = run["profile"]
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
