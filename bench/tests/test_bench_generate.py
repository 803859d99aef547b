"""The graph generator: deterministic for a seed, a valid CSR, the
configuration's sizes."""

import numpy as np
import torch
from tiny import tiny

from benchlib import generate


def arrays(seed):
    return generate.generate(tiny("products-rudder").config, seed, torch.device("cpu"))


def test_same_seed_same_graph_other_seed_other_graph():
    a, b, c = arrays(2**31 + 5), arrays(2**31 + 5), arrays(11)
    for name in ("indptr", "indices", "features", "labels", "train_nodes", "communities"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert not np.array_equal(a.features, c.features)
    assert not np.array_equal(a.indices, c.indices)


def test_csr_and_sizes():
    cfg = tiny("products-rudder").config
    g = arrays(3)
    sz = generate.sizes(cfg)
    n = sz["n"]
    assert g.num_nodes == n == 12000
    assert g.indptr[0] == 0 and g.indptr[-1] == len(g.indices)
    assert np.all(np.diff(g.indptr) >= 0)
    src = np.repeat(np.arange(n), np.diff(g.indptr))
    assert np.all(src != g.indices)                          # no self loops
    key = src * n + g.indices
    assert np.all(np.diff(key) > 0)                          # sorted, no duplicates
    assert np.array_equal(np.sort(g.indices * n + src), key)  # symmetric
    # Every edge the configuration asks for, after deduplication: the
    # configuration's average degree.
    assert len(g.indices) == 2 * sz["num_edges"] == 2 * cfg["num_edges"]
    assert len(g.train_nodes) == sz["n_train"] and np.all(np.diff(g.train_nodes) > 0)
    assert g.features.shape == (n, cfg["feature_dim"]) and g.features.dtype == np.float32
    assert g.labels.min() >= 0 and g.labels.max() < cfg["num_classes"]
    assert np.all(np.diff(g.communities) >= 0)
    # Most edges stay inside a community (intra_prob 0.92).
    assert np.mean(g.communities[src] == g.communities[g.indices]) > 0.85


def test_init_weights_deterministic():
    a = generate.init_weights(5, 4, 3, 9, "cpu")
    b = generate.init_weights(5, 4, 3, 9, "cpu")
    assert [t.shape for t in a] == [(5, 4), (5, 4), (4,), (4, 3), (4, 3), (3,)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], a[1]) and float(a[2].abs().sum()) == 0.0


def test_the_copy_keeps_the_programs_recipe():
    """Drawn on another generator, at the program's own ``generate``'s
    nodes and kept edges, the copy's graph has its shape: as many edges,
    as many of them inside a community, as large a largest degree."""
    from repro_torch.graph.generate import generate as program_generate

    theirs = program_generate("products", seed=1, scale=0.5)
    cfg = tiny("products-rudder").config
    cfg.update(num_nodes=theirs.num_nodes, num_edges=len(theirs.indices) // 2,
               train_nodes=len(theirs.train_nodes))
    ours = generate.generate(cfg, 1, torch.device("cpu"))

    def shape(indptr, indices, comm):
        src = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        return len(indices) / 2, np.mean(comm[src] == comm[indices]), np.diff(indptr).max()

    (e1, i1, d1) = shape(ours.indptr, ours.indices, ours.communities)
    (e2, i2, d2) = shape(theirs.indptr, theirs.indices, theirs.communities)
    assert e1 == e2 and abs(i1 - i2) < 0.01 and abs(d1 / d2 - 1) < 0.15
    assert abs(len(ours.train_nodes) - len(theirs.train_nodes)) == 0
