"""``train_wait_ms``: seconds of the program's ``train.wait`` spans (each
PE's ``float(loss)``: the host blocked until its forward and backward have
run) in the traced window over its steps, in milliseconds."""

from benchlib.spans import per_step_ms


def read(run):
    return per_step_ms(run, ("train.wait",))
