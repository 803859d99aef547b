"""``store_gather_ms``: seconds of the program's ``fetch.gather`` spans in
the traced window over its steps, in milliseconds: the feature store's
gather of the step's miss rows, sent before the next sample (only with a
store attached)."""

from benchlib.spans import per_step_ms


def read(run):
    return per_step_ms(run, ("fetch.gather",))
