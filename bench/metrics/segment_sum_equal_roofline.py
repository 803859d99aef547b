"""``segment_sum_equal_roofline``: the fanout means' segment sum
(``kernels.ops.segment_sum_equal``, with the ``1 / k`` scale in its
epilogue) against its roofline in the profiled call: the launches' least
time over their device time. A launch's bytes are its rows read once and
its sums written once; its operations an add per element read and a
multiply per output element."""

from benchlib.roofline import tensor_bytes

DISPATCHER = "segment_sum_equal"


def cost(args, kwargs, out):
    data = args[0]
    return tensor_bytes((data,), (out,)), data.numel() + out.numel()


def read(run):
    name = "bench." + DISPATCHER
    dev = run["profile"].dispatcher_s.get(name) if run["profile"] else None
    least = run["least_s"].get(name)
    if not dev or not least:
        return None
    return 100.0 * least / dev
