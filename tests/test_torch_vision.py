"""Phi-3-vision-4.2B's patch prefix in the port against the reference, on
the CPU, at the reference's smoke config (Phi-3-mini's backbone at 2
layers, d_model 256, 8 patches through ``vision_proj``).

The reference's ``init_params`` are carried across by ``params_from_jax``;
tokens and patches are made with numpy from a seed:

* the zoo's tests of ``tests/test_torch_zoo.py`` on this config (config
  field by field, scan groups, trees, text-only ``forward`` /
  ``decode_step`` 1e-4 / 3e-2, ``forward`` vs decode, ``serve_batch``
  tokens, the CLI);
* ``forward`` with float32 patches, at 1e-4 / 3e-2 (float32 / bfloat16):
  a bf16 projector multiplies float32 patches in float32, as the
  reference's einsum promotes them, then the result is cast to the
  model's dtype and put before the text; the prefill step with patches;
* ``lm_loss`` over the text positions after the prefix (1e-5) and every
  gradient, ``vision_proj``'s included (1e-4 x the leaf's largest);
  ``remat=True`` bit-identical; 3 ``make_train_step`` steps on
  ``TokenPipeline`` batches with patches against the reference's;
* the twins of ``tests/test_launch_steps.py``'s specs on this config.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train
import test_torch_zoo as zoo
from repro import configs as jconfigs
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch import roofline
from repro_torch.data import TokenPipeline, make_batch_specs
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten

ARCH = "phi-3-vision-4.2b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
S = 10
port_cfg, leaves = zoo.port_cfg, zoo.leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_zoo_ssm.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("test", [
    zoo.test_get_config_equals_the_reference_field_by_field,
    zoo.test_scan_groups_match_the_reference,
    zoo.test_params_from_jax_carries_every_leaf,
    zoo.test_init_params_tree_matches_the_reference,
    zoo.test_full_width_trees_match_the_reference_by_shape,
    zoo.test_decode_matches_forward,
    zoo.test_prefill_step_matches_the_reference,
    zoo.test_serve_batch_tokens_equal_the_reference,
], ids=lambda f: f.__name__.removeprefix("test_"))
def test_zoo_checks(test):
    """The zoo's tests on Phi-3-vision, text only (``vision_proj`` among
    the trees' leaves)."""
    test(ARCH)


@pytest.mark.parametrize("long_mode", [False, True], ids=["full", "long"])
def test_init_cache_matches_the_reference(long_mode):
    zoo.test_init_cache_matches_the_reference(ARCH, long_mode)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_forward_and_decode_match_the_reference(dtype):
    zoo.test_forward_matches_the_reference(ARCH, dtype)
    zoo.test_decode_step_matches_the_reference(ARCH, dtype)


def test_cli_serves_the_smoke_config(capsys):
    zoo.test_cli_serves_the_smoke_config(ARCH, capsys)


def test_full_width_projector():
    cfg = tconfigs.get_config(ARCH)
    tree = tmodel._draw_params(cfg, tmodel.SHAPES_ONLY)
    proj = tree["vision_proj"]
    assert (tuple(proj.shape), proj.dtype) == ((tmodel.VISION_EMBED_DIM, 3072), torch.bfloat16)
    assert sum(t.numel() for t in tmodel._leaves(tree)) == 3_824_225_280
    assert tmodel.train_state_bytes(cfg) == 45_891_502_080


# --------------------------------------------------------------------- #
# forward with patches
# --------------------------------------------------------------------- #
@functools.cache
def patches(batch=2, seed=4):
    cfg = jconfigs.get_smoke_config(ARCH)
    return np.random.default_rng(seed).normal(
        0, 0.02, size=(batch, cfg.num_patches, tmodel.VISION_EMBED_DIM)).astype(np.float32)


def reference(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_patches_matches_the_reference(dtype):
    cfg, params, port = zoo.model_pair(ARCH, dtype)
    toks = zoo.tokens(cfg.vocab_size, seq=S)
    with reference(dtype):
        fwd = functools.partial(jmodel.forward, cfg)
        fwd = jax.jit(fwd) if dtype == "float32" else fwd
        want, _ = fwd(params, jnp.asarray(toks), patches=jnp.asarray(patches()))
    with torch.no_grad():
        got, aux = tmodel.forward(port_cfg(cfg), port, torch.from_numpy(toks),
                                  patches=torch.from_numpy(patches()))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 8 + S, 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL[dtype], atol=TOL[dtype])
    assert float(aux) == 0.0


def test_projector_promotes_as_the_reference():
    """float32 patches and a bf16 projector multiply in float32 (where
    ``torch.einsum`` alone refuses the mix), then round to bf16 once."""
    cfg, params, port = zoo.model_pair(ARCH, "bfloat16")
    want = jnp.einsum("bpv,vd->bpd", jnp.asarray(patches()), params["vision_proj"])
    assert want.dtype == jnp.float32
    with pytest.raises(RuntimeError):
        torch.einsum("bpv,vd->bpd", torch.from_numpy(patches()), port["vision_proj"])
    got = torch.einsum("bpv,vd->bpd", torch.from_numpy(patches()),
                       port["vision_proj"].to(torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_prefill_step_with_patches_matches_the_reference():
    """The last position is the text's last token, after the prefix."""
    cfg, params, port = zoo.model_pair(ARCH, "float32")
    toks = zoo.tokens(cfg.vocab_size, seq=S)
    want = jax.jit(jsteps.make_prefill_step(cfg))(
        params, {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches())})
    with torch.no_grad():
        got = tsteps.make_prefill_step(port_cfg(cfg))(
            port, {"tokens": torch.from_numpy(toks), "patches": torch.from_numpy(patches())})
    assert tuple(got.shape) == (2, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #
@functools.cache
def train_batch():
    return JPipeline(jconfigs.get_smoke_config(ARCH), 2, 12, seed=5).next_batch()


@functools.cache
def reference_loss_and_grads():
    cfg, params, _ = zoo.model_pair(ARCH, "float32")
    batch = {k: jnp.asarray(v) for k, v in train_batch().items()}
    fn = jax.jit(jax.value_and_grad(lambda p: jmodel.lm_loss(cfg, p, batch), has_aux=True))
    (loss, metrics), grads = fn(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, [
        np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


@functools.cache
def port_loss_and_grads(remat):
    cfg, _, port = zoo.model_pair(ARCH, "float32")
    batch = {k: torch.from_numpy(v) for k, v in train_batch().items()}
    return tsteps.loss_and_grads(port_cfg(cfg), port, batch, remat=remat)


def test_pipeline_batches_carry_the_patches():
    got = TokenPipeline(tconfigs.get_smoke_config(ARCH), 2, 12, seed=5).next_batch()
    assert got.keys() == train_batch().keys() == {"tokens", "patches"}
    for k, v in train_batch().items():
        np.testing.assert_array_equal(got[k], v)


def test_lm_loss_matches_the_reference():
    want_loss, want_metrics, _ = reference_loss_and_grads()
    loss, metrics, _ = port_loss_and_grads(False)
    assert set(metrics) == set(want_metrics) == {"ce", "aux"}
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(metrics["ce"]), want_metrics["ce"], rtol=1e-5, atol=0)


def test_grads_match_the_reference():
    """Every leaf in the reference's ``tree_leaves`` order, ``vision_proj``
    (the loss reaches it through the prefix's attention) included."""
    _, _, want = reference_loss_and_grads()
    _, _, grads = port_loss_and_grads(False)
    got, _ = flatten(grads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        tol = 1e-4 * np.abs(w).max() + 1e-7
        assert np.abs(g.numpy() - w).max() <= tol, (i, np.abs(g.numpy() - w).max(), tol)
    proj = grads["vision_proj"]
    assert tuple(proj.shape) == (tmodel.VISION_EMBED_DIM, 256) and proj.abs().max() > 0


def test_remat_is_bit_identical():
    loss, metrics, grads = port_loss_and_grads(False)
    loss_r, metrics_r, grads_r = port_loss_and_grads(True)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(a, b) for a, b in zip(flatten(grads)[0], flatten(grads_r)[0]))


def test_three_steps_follow_the_reference():
    cfg, params, _ = zoo.model_pair(ARCH, "float32")
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    step = jax.jit(jsteps.make_train_step(cfg, lr=3e-3, remat=False))
    opt = jadamw_init(params, cfg.opt_dtype)
    pipe = JPipeline(cfg, 2, 16, seed=3)
    want = []
    for _ in range(3):
        params, opt, metrics = step(params, opt, {k: jnp.asarray(v) for k, v in
                                                  pipe.next_batch().items()})
        want.append(float(metrics["loss"]))
    pc = port_cfg(cfg)
    t_opt = adamw_init(port, pc.opt_dtype)
    t_step = tsteps.make_train_step(pc, lr=3e-3, remat=False)
    t_pipe = TokenPipeline(pc, 2, 16, seed=3)
    got = []
    for _ in range(3):
        port, t_opt, metrics = t_step(port, t_opt, {k: torch.from_numpy(v) for k, v in
                                                    t_pipe.next_batch().items()})
        got.append(float(metrics["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_train_step_reduces_loss():
    """Twin of ``tests/test_models_smoke.py``'s (bf16, patches)."""
    test_torch_train.test_train_step_reduces_loss(ARCH)


def test_chip_smoke_train_flops_counts_the_step():
    """``chip_smoke.train_flops`` (phase 16c's model FLOPs) equals
    ``FlopCounterMode``'s count of a gradient pass with the patches, as
    ``tests/test_torch_train.py`` holds it for the other configs (three
    layers of the smoke config)."""
    import importlib.util
    from pathlib import Path

    from torch.utils.flop_counter import FlopCounterMode

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = tconfigs.get_smoke_config(ARCH).with_overrides(dtype="float32", num_layers=3)
    params = tmodel.init_params(cfg, 0, device="cpu")
    batch = {"tokens": torch.from_numpy(zoo.tokens(cfg.vocab_size, batch=2, seq=16)),
             "patches": torch.from_numpy(patches(batch=2))}
    counted = {torch.ops.aten.addmm_: roofline.addmm_flops}
    with FlopCounterMode(display=False, custom_mapping=counted) as fc:
        tsteps.loss_and_grads(cfg, params, batch, remat=False)
    assert fc.get_total_flops() == cs.train_flops(cfg, 2, 16)


def test_train_cli(capsys):
    ttrain.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "8", "--device",
                 "cpu"])
    assert "loss " in capsys.readouterr().out


# --------------------------------------------------------------------- #
# abstract inputs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", list(tsteps.SHAPES))
def test_input_specs_match_the_reference(shape):
    """Twin of ``TestInputSpecs``: every leaf ``meta``, with the
    reference's shapes and dtypes (patches ``(B, 576, 1024)`` float32)."""
    got = tsteps.input_specs(tconfigs.get_config(ARCH), shape)
    want = jsteps.input_specs(jconfigs.get_config(ARCH), shape)
    g = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in leaves(got)}
    assert all(v.device.type == "meta" for _, v in leaves(got))
    assert g == {k: (tuple(v.shape), str(v.dtype)) for k, v in leaves(want)}
    if shape == "train_4k":
        assert tuple(got["batch"]["patches"].shape) == (256, 576, 1024)


def test_batch_specs_are_the_pipeline_batches():
    cfg = tconfigs.get_smoke_config(ARCH)
    specs = make_batch_specs(cfg, 2, 12)
    batch = TokenPipeline(cfg, 2, 12).next_batch()
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in specs.items()} \
        == {k: (v.shape, str(v.dtype)) for k, v in batch.items()}
