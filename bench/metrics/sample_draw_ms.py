"""``sample_draw_ms``: seconds of the program's ``sample.draw`` spans (the
sampler's uniform draws and their stacking, ``SamplerPlane._expand_blocks``)
in the traced window over its steps, in milliseconds."""

from benchlib.spans import per_step_ms


def read(run):
    return per_step_ms(run, ("sample.draw",))
