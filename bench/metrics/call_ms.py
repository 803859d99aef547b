"""``call_ms``: seconds of each ``run()`` call's own work in the traced window
over its steps, in milliseconds: the program's ``call.engine`` (the device
engine built and uploaded, the store attached), ``fused.prime``,
``call.accuracy`` and ``call.sync`` spans. None for a program without the
``call.*`` spans."""

from benchlib.spans import per_step_ms

NAMES = ("call.engine", "fused.prime", "call.accuracy", "call.sync")


def read(run):
    if not any(name.startswith("call.") for name, _, _ in run["spans"]):
        return None
    return per_step_ms(run, NAMES)
