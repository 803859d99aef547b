"""``step_ms_p95``: the 95th percentile (numpy's, linear between ranks) of
the program's ``step`` span durations in the traced window, in
milliseconds."""

import numpy as np


def read(run):
    d = [t1 - t0 for name, t0, t1 in run["spans"] if name == "step"]
    return 1e3 * float(np.percentile(d, 95)) if d else None
