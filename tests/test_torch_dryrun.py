"""The port's dry-run (``repro_torch.launch.dryrun``): counts of placed
steps on fake meshes of smoke configs, against the unsharded count, the
specs' arithmetic, collectives derived by hand, and the reference's own
``build_lowered`` (per-device argument bytes).

The fake process groups live in a subprocess (``tests/torch_worlds.py
dryrun``): a default process group must not outlive its test in a worker.
The reference lowers and compiles in another (``dryrun_ref``), on four of
its forced host devices.
"""

import json
import math
from collections import Counter

import pytest
import torch.distributed as dist

import torch_worlds as W

B, S = W.DRY_SHAPES["t_train"]["batch"], W.DRY_SHAPES["t_train"]["seq"]
ITEMSIZE = {"bfloat16": 2, "float32": 4}


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    port = W.start_port("dryrun", out / "port.json")
    ref = W.start_reference("dryrun_ref", out / "ref.json")
    W.finish_reference(port)
    W.finish_reference(ref)
    return json.loads((out / "port.json").read_text()), json.loads((out / "ref.json").read_text())


def test_importing_starts_no_world():
    import repro_torch.launch.dryrun  # noqa: F401

    assert not dist.is_initialized()


def test_a_mesh_of_one_moves_nothing(counts):
    """On a (1, 1) mesh a placed step issues no collective and counts the
    unsharded step's FLOPs."""
    port, _ = counts
    assert len(port["one"]) == 9
    for key, c in port["one"].items():
        assert c["placed"]["records"] == [], key
        assert c["placed"]["vector"]["flops"] == c["plain"]["vector"]["flops"] > 0, key
        assert c["plain"]["records"] == [], key


def test_data_parallel_is_a_quarter_batch(counts):
    """On (data=4, model=1) a rank counts the unsharded step at a quarter
    of the batch, FLOP for FLOP."""
    port, _ = counts
    assert len(port["dp"]) == 4
    for key, c in port["dp"].items():
        assert c["placed"]["flops"] == c["plain"]["flops"] > 0, key


def test_model_parallel_parameter_bytes(counts):
    """On (data=1, model=4) a rank holds each leaf's bytes over the
    product of its spec's axes."""
    port, _ = counts
    sizes = {"data": 1, "model": 4}
    for arch, c in port["tp_bytes"].items():
        expect = 0
        for nbytes, spec in c["leaves"]:
            axes = [a for e in spec if e is not None for a in (e if isinstance(e, list) else [e])]
            expect += nbytes // math.prod(sizes[a] for a in axes)
        assert c["local"] == expect, arch
        assert any(e is not None for _, spec in c["leaves"] for e in spec)


def _leaf_bytes(leaf) -> int:
    shape, dtype, _, _ = leaf
    return math.prod(shape) * ITEMSIZE[dtype]


def test_data_parallel_collectives_pinned(counts):
    """Phi-3.5-MoE's smoke config, 2 layers, one training step on
    (data=2, model=1). The update reduces each gradient once into its
    ZeRO moment's shard (a reduce-scatter of half its bytes: the expert
    stacks' and the router's too, which the MoE layer leaves partial over
    'data'), all-reduces each shard's squared norm (4 bytes), and gathers
    each updated parameter whole. The loss and gradients need two: each
    MoE layer's load-balance pmean (4 bytes) and the mean of the picked
    log-probabilities, which DTensor takes after gathering them over the
    batch (B x (S - 1) float32)."""
    port, _ = counts
    c = port["pinned"]["2x1"]
    leaves = c["leaves"]
    assert all("data" in [a for a in zspec if a is not None] for _, _, zspec, _ in leaves)
    assert any(path.endswith("ffn/w_up") for *_, path in leaves)
    expect = ([["reduce-scatter", _leaf_bytes(leaf) // 2] for leaf in leaves]
              + [["all-reduce", 4]] * len(leaves)
              + [["all-gather", _leaf_bytes(leaf)] for leaf in leaves])
    assert c["update"] == expect
    assert Counter(map(tuple, c["step"])) == Counter(
        {("all-reduce", 4): 2, ("all-gather", B * (S - 1) * 4): 1})


def test_model_parallel_collectives_pinned(counts):
    """The same step on (data=1, model=2). The update all-reduces the
    gradients that are partial sums over 'model' (the final norm's, read
    by the vocabulary-parallel unembedding; each layer's first norm's,
    read by the head-sharded attention; the second norm feeds the MoE
    layer, whose input gradient is summed over the ep ranks already) and
    each model-sharded leaf's squared norm. The loss and gradients: the
    embedding's vocabulary all-reduce and the residual stream's sums
    (B x S x D bf16: before each norm but the first, each MoE layer's psum
    combine; backward, at the norms and out of the MoE layers), the two
    load-balance pmeans, the cross entropy's row maxima, sums and picks
    and the log-softmax gradient's row sums (B x (S - 1) float32), and
    each router's gradient over the ep ranks (D x E float32)."""
    port, _ = counts
    c = port["pinned"]["1x2"]
    by_path = {leaf[3]: leaf for leaf in c["leaves"]}
    norms = [_leaf_bytes(by_path["final_norm/scale"]),
             _leaf_bytes(by_path["groups/0/b0/norm1/scale"])]
    sharded = [leaf for leaf in c["leaves"] if "model" in leaf[2]]
    assert len(sharded) == 9
    assert c["update"] == [["all-reduce", n] for n in norms] + [["all-reduce", 4]] * 9
    d, e = 256, 4
    assert Counter(map(tuple, c["step"])) == Counter({
        ("all-reduce", B * S * d * 2): 15, ("all-reduce", 4): 2,
        ("all-reduce", B * (S - 1) * 4): 4, ("all-reduce", d * e * 4): 2})


def test_argument_bytes_equal_the_reference(counts):
    """Per-device argument bytes of Qwen3-8B's smoke config on a (2, 2)
    mesh equal the reference's ``memory_analysis()``, at prefill, decode
    and training."""
    port, ref = counts
    for shape in W.ARG_SHAPES:
        assert port["args"][shape] == ref[shape]["args"], shape


def test_rows_render_through_the_reference_table(counts):
    from benchmarks.roofline_table import render

    port, _ = counts
    rows = port["rows"]
    assert [r["status"] for r in rows] == ["ok", "skipped"]
    assert {"t_compute_s", "t_memory_s", "t_collective_s", "bottleneck", "useful_ratio",
            "count_s", "bytes_per_device", "temp_bytes", "coll_breakdown"} <= set(rows[0])
    assert "lower_s" not in rows[0] and "compile_s" not in rows[0]
    table = render(rows, "single pod").splitlines()
    assert table[0] == "### single pod"
    assert table[4].startswith(f"| {rows[0]['arch']} | {rows[0]['shape']} | **memory** |")
    assert table[5] == f"| {rows[1]['arch']} | long_500k | n/a (skip) | - | - | - | - |"
