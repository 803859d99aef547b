"""``seeds_per_s.store``: training seeds of all PEs over the wall time of
the traced window's calls after the profiled one (ending, as the
untraced window does, in a synchronise), in the store's cell, where this
quantity is too unsteady to be held end to end; it moves ``setup_s``,
whose warm-up call runs the same steps."""


def read(run):
    steps, wall = run.get("window_steps", 0), run.get("window_s", 0.0)
    if not steps or wall <= 0:
        return None
    return steps * run["num_pes"] * run["batch"] / wall
