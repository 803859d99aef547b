"""``fused_frontier_step_roofline``: the raw loop's fused frontier launch
(``kernels.ops.fused_frontier_step_batch``) against its roofline in the
profiled call: the launches' least time over their device time. A
launch's least time is the larger of its bytes over the HBM bandwidth
and its operations (``frontier_ops``) over the float32 rate, both from
the launch's own arguments, so they count the work, whatever implements
it. Bytes: the buffer state, the frontier block, the candidates and the
outputs, each read or written once (``tensor_bytes``); of the tables the
launch indexes by node, what this launch needs: the partition map's
entries of the frontier's distinct ids, the candidates' node weights
(when the policy weighs), and per admitted node its row of the feature
store's table read, its slot of the payload written and its entry of
the store's row map."""

import torch

from benchlib.roofline import frontier_ops, tensor_bytes

DISPATCHER = "fused_frontier_step_batch"


def cost(args, kwargs, out):
    ids, scores, valid, accessed, in_cap, weights, aug, part_of, cand = args[:9]
    node_w, payload, table, loc = args[9:13]
    ids2, s2, valid2, acc3, w2, _payload2, cand_next, packed, counters = out
    fixed = tensor_bytes(
        (ids, scores, valid, accessed, in_cap, weights, aug, cand),
        (ids2, s2, valid2, acc3, w2, cand_next, packed, counters),
    )
    nops = frontier_ops(args)

    def later():
        frontier = aug[:, :-1]
        distinct = int(torch.unique(frontier[frontier >= 0]).numel())
        nbytes = fixed + distinct * part_of.element_size()
        if node_w is not None:
            nbytes += cand.numel() * node_w.element_size()
        if table is not None:
            placed = int(counters[:, 2].sum())
            row = table.shape[1] * table.element_size()
            nbytes += placed * (2 * row + loc.element_size())
        return nbytes, nops

    return later


def read(run):
    name = "bench." + DISPATCHER
    dev = run["profile"].dispatcher_s.get(name) if run["profile"] else None
    least = run["least_s"].get(name)
    if not dev or not least:
        return None
    return 100.0 * least / dev
