"""``sample_expand_ms``: seconds of the program's ``sample.expand`` spans
(the per-layer degree, offset and neighbour gathers and the frontier's
concatenation, ``SamplerPlane._expand_blocks``) in the traced window over
its steps, in milliseconds."""

from benchlib.spans import per_step_ms


def read(run):
    return per_step_ms(run, ("sample.expand",))
