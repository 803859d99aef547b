"""``fetched_rows_per_seed``: remote feature rows fetched (the program's
``fetch.miss_nodes`` and ``fetch.replaced_nodes`` counters, over all PEs)
over the training seeds of the traced window."""


def read(run):
    c = run["counters"]
    if "fetch.miss_nodes" not in c or not run["seeds"]:
        return None
    return (c["fetch.miss_nodes"] + c.get("fetch.replaced_nodes", 0.0)) / run["seeds"]
