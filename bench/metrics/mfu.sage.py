"""``mfu.sage``: GraphSAGE's forward and backward FLOPs over the traced
window's wall time (the program's ``run`` spans), as a share of one
H100's float32 peak outside the tensor cores (67 TFLOP/s; the products
run in float32 with TF32 off).

The FLOPs of one PE's step are counted from the layers' shapes and the
step's rows: the matrix products of both layers forward (two per layer
and row: self and neighbour mean), their weight gradients, the input
gradients of layer 2 (layer 1's inputs are data), and the neighbour
means' adds (the layer-2 neighbours', the layer-1 neighbours' and the
hidden mean, forward, and the hidden mean's backward). Elementwise work
(bias, ReLU, softmax) is left out.
"""

from benchlib.roofline import FP32_OPS_PER_S


def step_flops(batch, fanouts, feature_dim, hidden, classes) -> int:
    b, (f1, f2), F, H, C = batch, fanouts, feature_dim, hidden, classes
    rows1 = b * f1 + b                     # layer 1 runs on the neighbours and the seeds
    layer1 = 2 * 2 * rows1 * F * H         # x @ w_self + mean @ w_nbr
    layer2 = 2 * 2 * b * H * C
    means = b * f1 * f2 * F + b * f1 * F + b * f1 * H
    forward = layer1 + layer2 + means
    backward = layer1 + 2 * layer2 + b * f1 * H
    return forward + backward


def read(run):
    wall = sum(t1 - t0 for name, t0, t1 in run["spans"] if name == "run")
    if wall <= 0 or not run["steps"]:
        return None
    cfg, tr = run["config"], run["traffic"]
    per_pe = step_flops(run["batch"], tuple(tr["fanouts"]), cfg["feature_dim"],
                        cfg["model"]["hidden_dim"], cfg["num_classes"])
    flops = per_pe * run["num_pes"] * run["steps"]
    return 100.0 * flops / wall / FP32_OPS_PER_S
