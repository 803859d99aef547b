"""``gather_mean_roofline``: the layer-2 neighbour mean read straight from
the feature table (``kernels.ops.gather_mean``) against its roofline in
the profiled call: the launches' least time over their device time. A
launch's bytes are its distinct table rows read once, its output rows
written once and its index; its operations an add per gathered element
and a multiply per output element."""

import torch

DISPATCHER = "gather_mean"


def cost(args, kwargs, out):
    table, idx = args[0], args[1]
    B, K = idx.shape
    F = table.shape[1]
    size = table.element_size()

    def later():
        uniq = int(torch.unique(idx).numel())
        return uniq * F * size + B * F * size + idx.numel() * idx.element_size(), B * K * F + B * F

    return later


def read(run):
    name = "bench." + DISPATCHER
    dev = run["profile"].dispatcher_s.get(name) if run["profile"] else None
    least = run["least_s"].get(name)
    if not dev or not least:
        return None
    return 100.0 * least / dev
