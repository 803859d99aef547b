"""The port's classifier plane against the reference's, on the CPU.

Mirrors the reference's ``tests/test_classifiers.py`` (every model learns
a separable rule, the unfitted model raises, the featurizer, the S'
labels, online fine-tuning), the classifier cases of
``tests/test_gnn_train.py`` (``collect_traces``, a classifier-driven
rudder run, the decision rate against an LLM agent) and the evaluate
cases of ``tests/test_agent.py``. Parity with the reference:

* a gradient model fitted from the reference's initial arrays
  (``fit(..., init=...)``) ends at parameters allclose to the
  reference's fitted ones;
* given the reference's fitted parameters (:func:`params_from_jax`), its
  logits agree on every held-out row and its decisions are identical;
* the tree models (numpy, copied) are identical;
* one online fine-tune round moves the head as the reference's does and
  leaves the other layers alone; on TabNet both packages raise the same
  ``ValueError`` (the reference reads the head index off every ``w`` key,
  TabNet's ``"wa"`` among them);
* ``collect_traces`` returns the reference's ``X`` and ``y`` exactly, on
  the device loop (``device="cpu"``) and the staged loop; a classifier
  drives the same decisions on the device, staged and legacy loops.

Tolerances: fitted parameters ``rtol=1e-5, atol=1e-6`` (200 float32 SGD
steps, the same permutation draws, another summation order); logits from
the same parameters ``rtol=1e-6, atol=1e-6``; the fine-tuned head
``rtol=1e-6, atol=1e-7``; everything else exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jgraph
from repro.core import LLMAgent as JLLMAgent
from repro.core import classifiers as J
from repro.core import evaluate as jevaluate
from repro.core import make_backend as jmake_backend
from repro.gnn.train import collect_traces as jcollect
from repro_torch.core import LLMAgent, make_backend, make_classifier
from repro_torch.core import evaluate
from repro_torch.core.classifiers import (
    CLASSIFIERS,
    NUM_FEATURES,
    featurize,
    label_traces,
    params_from_jax,
)
from repro_torch.core.metrics import GraphMeta, Metrics
from repro_torch.gnn import DistributedTrainer
from repro_torch.gnn.train import collect_traces
from repro_torch.graph import generate, partition_graph

GRADIENT = ["lr", "mlp", "svm", "tabnet"]
TREES = ["rf", "xgb"]
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
LOGIT_RTOL, LOGIT_ATOL = 1e-6, 1e-6


def synth_traces(n=400, seed=0):
    """Separable synthetic traces: label = f(hits trend, comm)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, size=(n, NUM_FEATURES)).astype(np.float32)
    y = ((X[:, 0] < 0.5) & (X[:, 2] > 0.3)).astype(np.float32)
    return X, y


def _numpy(params) -> dict:
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("name", sorted(CLASSIFIERS))
def test_classifier_learns_separable_rule(name):
    """The reference's bar, from the reference's start: a gradient model
    fits from the reference's ``init_params()`` arrays (its own torch
    stream is another start, and for the linear models 200 SGD steps leave
    the held-out accuracy to the start's luck: the reference's ``lr``
    reaches 0.40 at ``seed=2``, the port's torch start 0.58 at ``seed=0``)."""
    X, y = synth_traces()
    clf = make_classifier(name, threshold=0.5, device="cpu")
    if name in GRADIENT:
        clf.fit(X[:300], y[:300], init=_numpy(J.make_classifier(name).init_params()))
    else:
        clf.fit(X[:300], y[:300])
    acc = np.mean([clf.decide(x) == bool(t) for x, t in zip(X[300:], y[300:])])
    assert acc > 0.7, f"{name} acc {acc}"


def test_unfitted_classifier_raises():
    with pytest.raises(RuntimeError, match="must be fit"):
        make_classifier("mlp", device="cpu").decide(np.zeros(NUM_FEATURES, np.float32))


def test_featurize_shape_and_range():
    m = Metrics(3, 50, 0, 5, 42.0, 120, 3.0, 0.8, 200)
    x = featurize(m, None, [40.0, 41.0, 42.0, 42.0])
    assert x.shape == (NUM_FEATURES,)
    assert np.all(np.isfinite(x))


def test_label_traces_s_prime_rule():
    hits = np.array([10.0, 20.0, 20.0, 15.0])
    comm = np.array([100.0, 90.0, 95.0, 95.0])
    labels = label_traces(hits, comm, np.zeros(4))
    assert labels[0] == 1.0  # hits up, comm down -> good
    assert labels[2] == 0.0  # hits flat, comm flat -> not good
    rng = np.random.default_rng(2)
    h, c = rng.uniform(0, 100, 64), rng.integers(0, 500, 64).astype(np.float64)
    np.testing.assert_array_equal(label_traces(h, c, c), J.label_traces(h, c, c))


def test_online_finetune_updates_head():
    X, y = synth_traces()
    clf = make_classifier("mlp", finetune_every=8, device="cpu").fit(X[:100], y[:100])
    before = {k: v.clone() for k, v in clf.params.items()}
    for x in X[100:120]:
        clf.decide(x)
    head = max(int(k[1:]) for k in clf.params if k.startswith("w"))
    assert not torch.allclose(before[f"w{head}"], clf.params[f"w{head}"])
    assert torch.equal(before["w0"], clf.params["w0"])  # frozen feature layer


def test_make_classifier_rejects_unknown_and_routes_device():
    with pytest.raises(KeyError, match="unknown classifier"):
        make_classifier("knn")
    assert make_classifier("lr", device="cpu").device == "cpu"
    assert not hasattr(make_classifier("rf", device="cpu"), "device")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_classifier("mlp").fit(*synth_traces(n=20))


def test_torch_init_is_seeded_and_shaped_like_the_reference():
    for name in GRADIENT:
        a = make_classifier(name, seed=3, device="cpu").init_params()
        b = make_classifier(name, seed=3, device="cpu").init_params()
        ref = J.make_classifier(name, seed=3).init_params()
        assert list(a) == list(ref)
        for k in a:
            assert a[k].shape == tuple(ref[k].shape) and torch.equal(a[k], b[k])


# --------------------------------------------------------------------------- #
# parity with the reference
def _fitted_pair(name, finetune_every=0):
    X, y = synth_traces()
    ref = J.make_classifier(name, threshold=0.5, finetune_every=finetune_every)
    init = _numpy(ref.init_params())
    ref.fit(X[:300], y[:300])
    port = make_classifier(name, threshold=0.5, finetune_every=finetune_every, device="cpu")
    port.fit(X[:300], y[:300], init=init)
    return X, ref, port


@pytest.mark.parametrize("name", GRADIENT)
def test_fit_from_reference_init_matches(name):
    _, ref, port = _fitted_pair(name)
    assert list(port.params) == list(ref.params)
    for k, v in ref.params.items():
        np.testing.assert_allclose(
            port.params[k].numpy(), np.asarray(v), rtol=PARAM_RTOL, atol=PARAM_ATOL,
            err_msg=k,
        )


@pytest.mark.parametrize("name", GRADIENT)
def test_reference_params_give_reference_decisions(name):
    X, ref, _ = _fitted_pair(name)
    port = make_classifier(name, threshold=0.5, device="cpu")
    port.params, port.trained = params_from_jax(_numpy(ref.params), "cpu"), True
    held = X[300:]
    z_ref = np.asarray(ref.logits(ref.params, jnp.asarray(held)))
    z_port = port.logits(port.params, torch.from_numpy(held)).numpy()
    np.testing.assert_allclose(z_port, z_ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    assert [port.decide(x) for x in held] == [ref.decide(x) for x in held]
    np.testing.assert_allclose(
        [port.predict_proba(x) for x in held], [ref.predict_proba(x) for x in held],
        rtol=LOGIT_RTOL, atol=LOGIT_ATOL,
    )


@pytest.mark.parametrize("name", TREES)
def test_tree_models_identical(name):
    X, y = synth_traces()
    ref = J.make_classifier(name).fit(X[:300], y[:300])
    port = make_classifier(name, device="cpu").fit(X[:300], y[:300])
    assert [tuple(map(float, s)) for s in port.stumps] == [
        tuple(map(float, s)) for s in ref.stumps
    ]
    assert [port.predict_proba(x) for x in X] == [ref.predict_proba(x) for x in X]
    assert [port.decide(x) for x in X] == [ref.decide(x) for x in X]


@pytest.mark.parametrize("name", ["lr", "mlp", "svm"])
def test_finetune_round_matches_reference(name):
    """From the same fitted parameters, one fine-tune round (8 decisions)
    moves the head as the reference's does; the other layers stay."""
    X, ref, _ = _fitted_pair(name, finetune_every=8)
    port = make_classifier(name, threshold=0.5, finetune_every=8, device="cpu")
    port.params, port.trained = params_from_jax(_numpy(ref.params), "cpu"), True
    before = {k: v.clone() for k, v in port.params.items()}
    for x in X[300:308]:
        assert port.decide(x) == ref.decide(x)
    head = max(int(k[1:]) for k in port.params if k.startswith("w"))
    assert not torch.equal(port.params[f"w{head}"], before[f"w{head}"])
    for k, v in ref.params.items():
        if k in (f"w{head}", f"b{head}"):
            np.testing.assert_allclose(port.params[k].numpy(), np.asarray(v),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            assert torch.equal(port.params[k], before[k]), k


def test_tabnet_finetune_raises_as_the_reference_does():
    """The reference's fault, kept: the head index is read off every key
    that starts with ``w``, and TabNet's attention key ``"wa"`` is one."""
    X, ref, port = _fitted_pair("tabnet", finetune_every=4)
    for clf in (ref, port):
        for x in X[300:303]:
            clf.decide(x)
        with pytest.raises(ValueError, match="invalid literal for int"):
            clf.decide(X[303])


# --------------------------------------------------------------------------- #
# collect_traces and the classifier-driven controller
@pytest.fixture(scope="module")
def parts():
    ref = jgraph.partition_graph(jgraph.generate("products", seed=0, scale=0.15), 4)
    port = partition_graph(generate("products", seed=0, scale=0.15), 4)
    return ref, port


COMMON = dict(epochs=5, batch_size=16, train_model=False, buffer_frac=0.25)


@pytest.mark.parametrize("device", ["cpu", False], ids=["device-loop", "staged"])
def test_collect_traces_equals_the_reference(parts, device):
    ref, port = parts
    X_ref, y_ref = jcollect(ref, epochs=2, batch_size=16)
    X, y = collect_traces(port, epochs=2, batch_size=16, device=device)
    assert X.shape[0] == y.shape[0] > 0
    assert X.dtype == X_ref.dtype and y.dtype == y_ref.dtype
    np.testing.assert_array_equal(X, X_ref)
    np.testing.assert_array_equal(y, y_ref)


def test_classifier_controller_runs(parts):
    """``test_gnn_train.py:80``; the port's three loops give one stream."""
    _, port = parts
    X, y = collect_traces(port, epochs=2, batch_size=16, device="cpu")
    runs = []
    for runtime, device in (("vectorized", "cpu"), ("legacy", "cpu"), ("vectorized", False)):
        clf = make_classifier("lr", device="cpu").fit(X, y)
        runs.append(DistributedTrainer(port, variant="rudder", deciders=[clf],
                                       runtime=runtime, device=device, **COMMON).run())
    r = runs[0]
    assert any(d for log in r.logs for d in log.decisions)
    assert r.mean_pct_hits > 0.0
    for other in runs[1:]:
        assert [log.decisions for log in other.logs] == [log.decisions for log in r.logs]
        assert other.epoch_times == r.epoch_times


def test_classifier_decides_more_frequently_than_llm(parts):
    """``test_gnn_train.py:91``: Table 2, classifier r ~1-2, LLM agents
    r >= latency."""
    _, port = parts
    X, y = collect_traces(port, epochs=2, batch_size=16, device="cpu")
    clf = make_classifier("lr", device="cpu").fit(X, y)
    r_clf = DistributedTrainer(port, variant="rudder", deciders=[clf], device="cpu",
                               **COMMON).run()
    r_llm = DistributedTrainer(port, variant="rudder", deciders=["qwen-1.5b"], device="cpu",
                               **dict(COMMON, epochs=14)).run()
    assert (
        r_clf.controllers[0].replacement_interval
        < r_llm.controllers[0].replacement_interval
    )


def test_reference_fitted_classifier_drives_identical_runs(parts):
    """A classifier shared by all PEs, fine-tuning on: with the
    reference's fitted parameters the port's run makes the reference's
    decisions."""
    ref_parts, port = parts
    import repro.gnn as jgnn

    X, y = collect_traces(port, epochs=2, batch_size=16, device="cpu")
    ref_clf = J.make_classifier("mlp", finetune_every=16).fit(X, y)
    port_clf = make_classifier("mlp", finetune_every=16, device="cpu")
    port_clf.params, port_clf.trained = params_from_jax(_numpy(ref_clf.params), "cpu"), True
    a = jgnn.DistributedTrainer(ref_parts, variant="rudder", deciders=[ref_clf],
                                **COMMON).run()
    b = DistributedTrainer(port, variant="rudder", deciders=[port_clf], device="cpu",
                           **COMMON).run()
    assert [log.decisions for log in b.logs] == [log.decisions for log in a.logs]
    assert b.epoch_times == a.epoch_times


# --------------------------------------------------------------------------- #
# evaluate (the cases of tests/test_agent.py)
GRAPH = GraphMeta("toy", 1000, 5000, 250, 1300, 4)


def mk_metrics(mb, hits, comm=100, occ=0.9, progress_total=100):
    return Metrics(
        minibatch=mb, total_minibatches=progress_total, epoch=0, total_epochs=1,
        pct_hits=hits, comm_volume=comm, replaced_pct=2.0, buffer_occupancy=occ,
        buffer_capacity=200,
    )


def test_pass_at_1_counts_matches():
    agent = LLMAgent(make_backend("gemma3-1b"), GRAPH)  # predicts "up"
    ref = JLLMAgent(jmake_backend("gemma3-1b"), GRAPH)
    for mb, hits in enumerate((10.0, 30.0, 5.0, 5.0)):
        agent.step(mk_metrics(mb, hits))
        ref.step(mk_metrics(mb, hits))
    res = evaluate.pass_at_1(agent.context.history, tol=0.5)
    assert res.n == 3
    assert res.pass_rate == pytest.approx(100.0 / 3, abs=1.0)
    want = jevaluate.pass_at_1(ref.context.history, tol=0.5)
    assert (res.pass_rate, res.ci_lo, res.ci_hi, res.n) == (
        want.pass_rate, want.ci_lo, want.ci_hi, want.n)
    assert str(res) == str(want)


def test_wilson_extremes_and_reference():
    lo, hi = evaluate.wilson_interval(0, 10)
    assert lo < 1e-9 and hi < 0.35
    lo, hi = evaluate.wilson_interval(10, 10)
    assert hi > 1 - 1e-9 and lo > 0.65
    for k, n in ((0, 0), (3, 7), (50, 120), (119, 120)):
        assert evaluate.wilson_interval(k, n) == jevaluate.wilson_interval(k, n)


def test_classifier_accuracy_and_agent_report_match_reference():
    rng = np.random.default_rng(4)
    d, lab = rng.random(40) < 0.5, rng.random(37) < 0.5
    got = evaluate.classifier_accuracy(list(d), list(lab))
    want = jevaluate.classifier_accuracy(list(d), list(lab))
    assert (got.pass_rate, got.ci_lo, got.ci_hi, got.n) == (
        want.pass_rate, want.ci_lo, want.ci_hi, want.n)
    agent = LLMAgent(make_backend("qwen-1.5b"), GRAPH)
    ref = JLLMAgent(jmake_backend("qwen-1.5b"), GRAPH)
    for mb in range(24):
        m = mk_metrics(mb, float(10 + 3 * (mb % 7)))
        agent.step(m)
        ref.step(m)
    assert evaluate.agent_report(agent) == jevaluate.agent_report(ref)
