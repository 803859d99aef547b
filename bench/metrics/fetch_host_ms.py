"""``fetch_host_ms``: seconds of the program's host work around the fetch
stage's launch in the traced window over its steps, in milliseconds: the
``fetch.pack`` (id checks, casts, gates, the frontier block and its
upload), ``fetch.unpack`` (the readback's bookkeeping) and
``fetch.account`` (counters, the time model, occupancy) spans, the prime's
included."""

from benchlib.spans import per_step_ms


def read(run):
    return per_step_ms(run, ("fetch.pack", "fetch.unpack", "fetch.account"))
