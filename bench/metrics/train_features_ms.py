"""``train_features_ms``: seconds of the program's ``train.features`` spans
(each PE's inputs of the GraphSAGE step: its rows, through the feature
store when one is attached, and the layer-2 mean) in the traced window
over its steps, in milliseconds."""

from benchlib.spans import per_step_ms


def read(run):
    return per_step_ms(run, ("train.features",))
