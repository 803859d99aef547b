"""``copied_bytes_per_seed``: bytes the program copied between host and
device (its ``device.h2d_bytes`` and ``device.d2h_bytes`` counters, every
site) over the training seeds of the traced window. None for a program
that does not count its copies by site (``device.<way>_bytes.<site>``)."""


def read(run):
    c = run["counters"]
    by_site = any(n.startswith(("device.h2d_bytes.", "device.d2h_bytes.")) for n in c)
    if not by_site or not run["seeds"]:
        return None
    return (c.get("device.h2d_bytes", 0.0) + c.get("device.d2h_bytes", 0.0)) / run["seeds"]
