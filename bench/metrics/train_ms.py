"""``train_ms``: seconds of the program's ``train`` spans in the traced window over
its steps, in milliseconds."""


def read(run):
    total = sum(t1 - t0 for name, t0, t1 in run["spans"] if name == "train")
    if not run["steps"] or not any(name == "train" for name, _, _ in run["spans"]):
        return None
    return 1e3 * total / run["steps"]
