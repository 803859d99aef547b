"""The port's GraphSAGE module against the reference's jax functions.

The reference draws its initial weights with ``jax.random``, which torch
cannot reproduce, so the same ``SageParams`` cross over through
``params_from_jax``. Inputs are made with numpy from a seed. Forward,
loss, gradients (autograd against ``jax.value_and_grad``) and accuracy
agree to ``rtol=1e-5, atol=1e-6`` in float32: the two frameworks sum the
fanout means and the matrix products in another order.
"""

import jax
import numpy as np
import pytest
import torch

from repro.gnn import sage as jsage
from repro_torch.gnn import sage as tsage

RTOL, ATOL = 1e-5, 1e-6
B, F1, F2, F, H, NC = 6, 3, 4, 10, 8, 5


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    params = jsage.init_sage(jax.random.PRNGKey(3), F, H, NC)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.01, np.shape(a)).astype(np.float32),
        params,
    )  # non-zero biases, so their gradients and layout are exercised too
    x_seed = rng.normal(size=(B, F)).astype(np.float32)
    x_n1 = rng.normal(size=(B, F1, F)).astype(np.float32)
    x_n2 = rng.normal(size=(B, F1, F2, F)).astype(np.float32)
    labels = rng.integers(0, NC, size=B).astype(np.int32)
    return params, (x_seed, x_n1, x_n2), labels


def _torch_inputs(xs, labels):
    return [torch.from_numpy(x) for x in xs], torch.from_numpy(labels.astype(np.int64))


def test_params_carry_across(case):
    params, _, _ = case
    model = tsage.params_from_jax(params)
    leaves = jax.tree_util.tree_leaves(params)
    named = dict(model.named_parameters())
    assert list(named) == list(tsage.PARAM_NAMES)
    for name, leaf in zip(tsage.PARAM_NAMES, leaves):
        np.testing.assert_array_equal(named[name].detach().numpy(), leaf, err_msg=name)
    # a plain nesting of arrays in the same layout works too
    nested = [[np.asarray(x) for x in layer] for layer in params]
    again = tsage.params_from_jax(nested)
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


def test_forward_loss_grads_match(case):
    params, xs, labels = case
    model = tsage.params_from_jax(params)
    txs, tlabels = _torch_inputs(xs, labels)

    logits = jsage.sage_forward(params, *xs)
    np.testing.assert_allclose(
        model(*txs).detach().numpy(), np.asarray(logits), rtol=RTOL, atol=ATOL
    )
    loss, grads = jsage.sage_grads(params, *xs, labels)
    tloss, tgrads = model.loss_and_grads(*txs, tlabels)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=RTOL, atol=ATOL)
    for name, g, tg in zip(tsage.PARAM_NAMES, jax.tree_util.tree_leaves(grads), tgrads):
        np.testing.assert_allclose(
            tg.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL, err_msg=name
        )
    assert all(p.grad is None for p in model.parameters())


def test_accuracy_matches(case):
    params, xs, labels = case
    model = tsage.params_from_jax(params)
    txs, tlabels = _torch_inputs(xs, labels)
    want = float(jsage.sage_accuracy(params, *xs, labels))
    assert model.accuracy(*txs, tlabels) == pytest.approx(want, abs=1e-7)


def test_init_layout_and_seed():
    a = tsage.init_sage(F, H, NC, generator=torch.Generator().manual_seed(1))
    b = tsage.init_sage(F, H, NC, generator=torch.Generator().manual_seed(1))
    shapes = [tuple(p.shape) for p in a.parameters()]
    assert shapes == [(F, H), (F, H), (H,), (H, NC), (H, NC), (NC,)]
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert not a.layer1.bias.detach().any()
