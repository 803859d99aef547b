"""``readback_wait_ms``: seconds of the program's ``device.wait`` spans in
the traced window over its steps, in milliseconds: inside the packed
readback, the host blocked until the launch and everything queued ahead
of it have finished; the rest of ``device.readback`` is the copy."""

from benchlib.spans import per_step_ms


def read(run):
    return per_step_ms(run, ("device.wait",))
