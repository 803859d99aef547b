"""Whisper-large-v3's encoder-decoder in the port against the reference,
on the CPU, at the reference's smoke config (2 encoder + 2 decoder
layers, d_model 256, ``encoder_seq`` 16).

The reference's ``init_params`` (``jax.random``) are carried across by
``params_from_jax``; tokens and frames are made with numpy from a seed,
and both packages run them:

* the config field by field, the scan groups and layer kinds, the
  parameter and cache trees (also at full width by shape against
  ``eval_shape``), ``params_from_jax`` leaf for leaf;
* ``_sinusoidal`` at (1500, 1280) and the smoke widths: the divisors bit
  for bit, the table within 1.2e-7 (XLA's sine and cosine differ from
  torch's by an ulp); the per-position sinusoid of the decode step equal
  to the table's row;
* ``cross_memory``, ``cross_forward``, and ``block_forward`` /
  ``block_decode`` for the ``enc`` and ``dec`` kinds; ``encode``,
  ``forward`` with frames and ``decode_step`` after
  ``prefill_cross_cache``, at 1e-4 / 3e-2 (float32 / bfloat16; in
  bfloat16 the reference runs op by op, ``jax.disable_jit()``, as in
  ``tests/test_torch_zoo.py``); ``prefill_cross_cache``'s ``ck`` / ``cv``;
* ``lm_loss`` within 1e-5 and every gradient within 1e-4 x the leaf's
  largest of ``jax.value_and_grad``'s; ``remat=True`` bit-identical;
* the twin of ``tests/test_decode_consistency.py`` (1e-3 x max(|logits|,
  1)); ``serve_batch`` tokens equal to the reference's in float32 (the
  frames drawn after the prompts from the same generator); 3
  ``make_train_step`` steps against the reference's; both CLIs;
* the twins of ``tests/test_launch_steps.py`` on Whisper (448 prefill
  tokens, the abstract trees against the reference's ``eval_shape`` and
  against ``init_cache``), and the frontend's specs and draws.
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
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import frontend as jfrontend
from repro.models import model as jmodel
from repro.optim import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch import roofline
from repro_torch.data import TokenPipeline
from repro_torch.kernels import native
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import frontend as tfrontend
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten

ARCH = "whisper-large-v3"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
S = 10
port_cfg, leaves, f32 = zoo.port_cfg, zoo.leaves, zoo.f32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_zoo_ssm.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference(dtype):
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


@functools.cache
def frames(batch=2, seed=4):
    cfg = jconfigs.get_smoke_config(ARCH)
    return np.random.default_rng(seed).normal(
        0, 0.02, size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


def layer(tree, i):
    """Layer ``i`` of a stacked group tree (numpy or jax leaves)."""
    return jax.tree_util.tree_map(lambda a: a[i], tree)


def port_tree(tree):
    return tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")


# --------------------------------------------------------------------- #
# configs, groups, trees
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("test", [
    zoo.test_get_config_equals_the_reference_field_by_field,
    zoo.test_scan_groups_match_the_reference,
    zoo.test_params_from_jax_carries_every_leaf,
    zoo.test_init_params_tree_matches_the_reference,
    zoo.test_full_width_trees_match_the_reference_by_shape,
], ids=lambda f: f.__name__.removeprefix("test_"))
def test_zoo_checks(test):
    """The zoo's config and tree tests on Whisper: every leaf of the
    encoder's groups, ``enc_final_norm`` and each decoder layer's
    ``norm_cross`` and ``cross`` included."""
    test(ARCH)


def test_the_trees_hold_the_encoder_and_the_cross_attention():
    cfg = tconfigs.get_config(ARCH)
    assert tmodel.layer_kinds(cfg) == ["dec"] * 32
    tree = tmodel._draw_params(cfg, tmodel.SHAPES_ONLY)
    assert {"enc_groups", "enc_final_norm"} <= tree.keys() and "unembed" not in tree
    assert tuple(tree["enc_groups"][0]["b0"]["mixer"]["wq"].shape) == (32, 1280, 20, 64)
    assert set(tree["groups"][0]["b0"]) == {"norm1", "mixer", "norm_cross", "cross", "norm2",
                                             "ffn"}
    assert sum(t.numel() for t in tmodel._leaves(tree)) == 1_534_809_600
    # bf16 leaves and float32 norms, their gradients, two float32 moments.
    assert tmodel.train_state_bytes(cfg) == sum(
        2 * t.nbytes + 8 * t.numel() for t in tmodel._leaves(tree)) == 18_419_374_080


@pytest.mark.parametrize("long_mode", [False, True], ids=["full", "long"])
def test_init_cache_matches_the_reference(long_mode):
    zoo.test_init_cache_matches_the_reference(ARCH, long_mode)
    cache = tmodel.init_cache(tconfigs.get_smoke_config(ARCH), 3, 21, device="cpu")
    assert tuple(cache[0]["b0"]["ck"].shape) == (2, 3, 16, 4, 64)


# --------------------------------------------------------------------- #
# the sinusoid
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("seq,d", [(1500, 1280), (16, 256), (S, 256)])
def test_sinusoidal_matches_the_reference(seq, d):
    want_div = np.asarray(jnp.power(10_000.0, jnp.arange(0, d, 2, dtype=jnp.float32) / d))
    got_div = tmodel._sin_divisors(d, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got_div, want_div)
    want = np.asarray(jmodel._sinusoidal(seq, d))
    got = tmodel._sinusoidal(seq, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, seq, d)
    assert np.abs(got.numpy() - want).max() <= 1.2e-7
    # The decode step's sinusoid at one position is the table's row.
    for pos in (0, seq // 2, seq - 1):
        row = tmodel._sinusoid(torch.full((1,), pos), d)
        assert torch.equal(row[0], got[0, pos])


# --------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_memory_and_cross_forward_match_the_reference(dtype):
    cfg, params, port = zoo.model_pair(ARCH, dtype)
    jdt, tdt = DT[dtype]
    jp, tp = layer(params["groups"][0], 1)["b0"]["cross"], layer(port["groups"][0], 1)["b0"]["cross"]
    rng = np.random.default_rng(6)
    mem = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    with reference(dtype):
        wk, wv = jattn.cross_memory(cfg, jp, jnp.asarray(mem).astype(jdt))
        want = jattn.cross_forward(cfg, jp, jnp.asarray(x).astype(jdt), wk, wv)
    with torch.no_grad():
        gk, gv = tattn.cross_memory(port_cfg(cfg), tp, torch.from_numpy(mem).to(tdt))
        got = tattn.cross_forward(port_cfg(cfg), tp, torch.from_numpy(x).to(tdt), gk, gv)
    assert got.dtype == tdt and gk.dtype == tdt
    for g, w in ((gk, wk), (gv, wv), (got, want)):
        np.testing.assert_allclose(f32(g), f32(w), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["enc", "dec"])
def test_block_forward_matches_the_reference(kind, dtype):
    cfg, params, port = zoo.model_pair(ARCH, dtype)
    jdt, tdt = DT[dtype]
    groups = "enc_groups" if kind == "enc" else "groups"
    jp, tp = layer(params[groups][0], 1)["b0"], layer(port[groups][0], 1)["b0"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)[None]
    with reference(dtype):
        jkv = jattn.cross_memory(cfg, jp["cross"], jnp.asarray(mem).astype(jdt)) if (
            kind == "dec") else None
        want, _ = jblocks.block_forward(cfg, kind, jp, jnp.asarray(x).astype(jdt),
                                        jnp.asarray(pos), memory_kv=jkv)
    with torch.no_grad():
        tkv = tattn.cross_memory(port_cfg(cfg), tp["cross"], torch.from_numpy(mem).to(tdt)) if (
            kind == "dec") else None
        got, aux = tblocks.block_forward(port_cfg(cfg), kind, tp, torch.from_numpy(x).to(tdt),
                                         torch.from_numpy(pos), memory_kv=tkv)
    assert float(aux) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype], atol=TOL[dtype])


def test_encoder_attention_sees_every_position():
    """``enc`` is bidirectional: a change at the last frame moves the
    first position's output; a ``dec`` layer's self attention is causal
    (its first position moves only through the cross attention)."""
    cfg, _, port = zoo.model_pair(ARCH, "float32")
    tp = layer(port["enc_groups"][0], 0)["b0"]
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((1, 6, cfg.d_model)).astype(
        np.float32))
    y = x.clone()
    y[0, -1] += 1.0
    pos = torch.arange(6)[None]
    with torch.no_grad():
        a = tattn.gqa_forward(port_cfg(cfg), tp["mixer"], x, pos, causal=False)
        b = tattn.gqa_forward(port_cfg(cfg), tp["mixer"], y, pos, causal=False)
        c = tattn.gqa_forward(port_cfg(cfg), tp["mixer"], x, pos)
        d = tattn.gqa_forward(port_cfg(cfg), tp["mixer"], y, pos)
    assert not torch.equal(a[0, 0], b[0, 0])
    assert torch.equal(c[0, :-1], d[0, :-1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_decode_dec_matches_the_reference(dtype):
    """Five positions of a ``dec`` layer's decode, each package carrying
    its cache (the port's written in place); the cross keys and values
    from ``cross_memory``."""
    cfg, params, port = zoo.model_pair(ARCH, dtype)
    jdt, tdt = DT[dtype]
    jp, tp = layer(params["groups"][0], 0)["b0"], layer(port["groups"][0], 0)["b0"]
    rng = np.random.default_rng(9)
    mem = rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    xs = rng.standard_normal((5, 2, 1, cfg.d_model)).astype(np.float32)
    with reference(dtype):
        jc = jblocks.init_layer_cache(cfg, "dec", 2, 6)
        jc["ck"], jc["cv"] = jattn.cross_memory(cfg, jp["cross"], jnp.asarray(mem).astype(jdt))
    tc = tblocks.init_layer_cache(port_cfg(cfg), "dec", 2, 6)
    with torch.no_grad():
        ck, cv = tattn.cross_memory(port_cfg(cfg), tp["cross"], torch.from_numpy(mem).to(tdt))
        tc["ck"].copy_(ck)
        tc["cv"].copy_(cv)
        for pos in range(5):
            with reference(dtype):
                want, jc = jblocks.block_decode(cfg, "dec", jp, jnp.asarray(xs[pos]).astype(jdt),
                                                jc, jnp.int32(pos))
            got, tc = tblocks.block_decode(port_cfg(cfg), "dec", tp,
                                           torch.from_numpy(xs[pos]).to(tdt), tc, pos)
            np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype], atol=TOL[dtype],
                                       err_msg=f"pos {pos}")


# --------------------------------------------------------------------- #
# the whole stack
# --------------------------------------------------------------------- #
@functools.cache
def reference_run(dtype):
    """The reference's encoder output, forward logits and decode logits
    at every position (after ``prefill_cross_cache``), and the filled
    cross cache."""
    cfg, params, _ = zoo.model_pair(ARCH, dtype)
    toks = jnp.asarray(zoo.tokens(cfg.vocab_size, seq=S))
    fr = jnp.asarray(frames())
    with reference(dtype):
        wrap = jax.jit if dtype == "float32" else (lambda f: f)
        memory = wrap(functools.partial(jmodel.encode, cfg))(params, fr)
        full, _ = wrap(functools.partial(jmodel.forward, cfg))(params, toks, frames=fr)
        cache = jmodel.init_cache(cfg, 2, S + 2)
        cache = jmodel.prefill_cross_cache(cfg, params, cache, fr)
        cross = (np.asarray(cache[0]["b0"]["ck"], np.float32),
                 np.asarray(cache[0]["b0"]["cv"], np.float32))
        step = wrap(functools.partial(jmodel.decode_step, cfg))
        dec = []
        for t in range(S):
            lg, cache = step(params, cache, toks[:, t : t + 1], jnp.int32(t))
            dec.append(np.asarray(lg[:, 0]))
    return (np.asarray(memory, np.float32), np.asarray(full), np.stack(dec, axis=1), cross)


@functools.cache
def port_run(dtype):
    cfg, _, port = zoo.model_pair(ARCH, dtype)
    pc = port_cfg(cfg)
    toks = torch.from_numpy(zoo.tokens(cfg.vocab_size, seq=S))
    fr = torch.from_numpy(frames())
    with torch.no_grad():
        memory = tmodel.encode(pc, port, fr)
        full, aux = tmodel.forward(pc, port, toks, frames=fr)
        cache = tmodel.init_cache(pc, 2, S + 2, device="cpu")
        assert tmodel.prefill_cross_cache(pc, port, cache, fr) is cache
        cross = (cache[0]["b0"]["ck"].clone(), cache[0]["b0"]["cv"].clone())
        dec = []
        for t in range(S):
            lg, cache = tmodel.decode_step(pc, port, cache, toks[:, t : t + 1], t)
            dec.append(lg[:, 0])
    return memory, full, float(aux), torch.stack(dec, dim=1), cross


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_the_reference(dtype):
    want = reference_run(dtype)[0]
    got = port_run(dtype)[0]
    assert got.dtype == DT[dtype][1] and tuple(got.shape) == (2, 16, 256)
    np.testing.assert_allclose(f32(got), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_frames_matches_the_reference(dtype):
    want = reference_run(dtype)[1]
    _, got, aux, _, _ = port_run(dtype)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, S, 512)
    assert aux == 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_cross_cache_matches_the_reference(dtype):
    want = reference_run(dtype)[3]
    got = port_run(dtype)[4]
    for g, w in zip(got, want):
        assert g.dtype == DT[dtype][1] and tuple(g.shape) == w.shape == (2, 2, 16, 4, 64)
        np.testing.assert_allclose(f32(g), w, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_the_reference(dtype):
    want = reference_run(dtype)[2]
    got = port_run(dtype)[3]
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


def test_decode_matches_forward():
    """Twin of ``tests/test_decode_consistency.py::test_decode_matches_forward``
    for Whisper (float32, the cross cache from ``prefill_cross_cache``)."""
    _, full, _, dec, _ = port_run("float32")
    err = (dec - full).abs().max().item()
    scale = full.abs().max().item()
    assert err < 1e-3 * max(scale, 1.0), f"{err} vs scale {scale}"


def test_forward_needs_frames():
    cfg, _, port = zoo.model_pair(ARCH, "float32")
    with pytest.raises(ValueError, match="needs frames"):
        tmodel.forward(port_cfg(cfg), port, torch.zeros((1, 3), dtype=torch.int32))


def test_prefill_step_matches_the_reference():
    cfg, params, port = zoo.model_pair(ARCH, "float32")
    toks = zoo.tokens(cfg.vocab_size, seq=S)
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames())}
    want = jax.jit(jsteps.make_prefill_step(cfg))(params, batch)
    with torch.no_grad():
        got = tsteps.make_prefill_step(port_cfg(cfg))(
            port, {"tokens": torch.from_numpy(toks), "frames": torch.from_numpy(frames())})
    assert tuple(got.shape) == (2, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, port_run("float32")[1][:, -1])


def test_serve_batch_tokens_equal_the_reference():
    """The frames are drawn from the serve generator after the prompts, in
    the model's dtype, and the cross cache filled before the prompts."""
    cfg, params, port = zoo.model_pair(ARCH, "float32")
    kw = dict(requests=3, prompt_len=8, gen_len=10, seed=2)
    want = jserve.serve_batch(ARCH, cfg=cfg, params=params, **kw)
    native.reset_launches()
    got = tserve.serve_batch(ARCH, cfg=port_cfg(cfg), params=port, device="cpu", **kw)
    assert got["tokens"].shape == (3, 10) and got["encode_s"] > 0
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert not any(native.LAUNCHES.values())


def test_cli_serves_the_smoke_config(capsys):
    zoo.test_cli_serves_the_smoke_config(ARCH, capsys)


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


def test_pipeline_batches_carry_the_frames():
    got = TokenPipeline(tconfigs.get_smoke_config(ARCH), 2, 12, seed=5).next_batch()
    assert got.keys() == train_batch().keys() == {"tokens", "frames"}
    for k, v in train_batch().items():
        np.testing.assert_array_equal(got[k], v)


def test_lm_loss_matches_the_reference():
    want_loss, want_metrics, _ = reference_loss_and_grads()
    loss, metrics, _ = port_loss_and_grads(False)
    assert set(metrics) == set(want_metrics) == {"ce", "aux"}
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5, atol=0)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_grads_match_the_reference():
    """Every leaf, the encoder's and the cross attention's included, in the
    reference's ``tree_leaves`` order."""
    _, _, want = reference_loss_and_grads()
    _, _, grads = port_loss_and_grads(False)
    got, _ = flatten(grads)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, i
        tol = 1e-4 * np.abs(w).max() + 1e-7
        assert np.abs(g.numpy() - w).max() <= tol, (i, np.abs(g.numpy() - w).max(), tol)
    assert all(np.abs(w).max() > 0 for w in want), "a leaf the loss does not reach"


def test_remat_is_bit_identical():
    """``remat=True`` recomputes each decoder layer's cross keys and
    values in backward: loss and every gradient as without."""
    loss, metrics, grads = port_loss_and_grads(False)
    loss_r, metrics_r, grads_r = port_loss_and_grads(True)
    assert torch.equal(loss, loss_r)
    assert all(torch.equal(metrics[k], metrics_r[k]) for k in metrics)
    assert all(torch.equal(a, b) for a, b in zip(flatten(grads)[0], flatten(grads_r)[0]))


def test_three_steps_follow_the_reference():
    """Twin of ``tests/test_torch_train_steps.py``'s: three steps from the
    same parameters on the same ``TokenPipeline`` batches (frames
    included), every loss within 1e-4 relative."""
    cfg, params, _ = zoo.model_pair(ARCH, "float32")
    port = port_tree(params)  # a copy: the port's steps update it in place
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
    """Twin of ``tests/test_models_smoke.py``'s (the port's own bf16
    ``init_params``, 5 steps at lr 3e-3 on one batch with frames)."""
    test_torch_train.test_train_step_reduces_loss(ARCH)


def test_chip_smoke_train_flops_counts_the_step():
    """``chip_smoke.train_flops`` (phase 16c's model FLOPs) equals
    ``FlopCounterMode``'s count of a gradient pass with the frames, as
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
             "frames": torch.from_numpy(frames(batch=2))}
    counted = {torch.ops.aten.addmm_: roofline.addmm_flops}
    with FlopCounterMode(display=False, custom_mapping=counted) as fc:
        tsteps.loss_and_grads(cfg, params, batch, remat=False)
    assert fc.get_total_flops() == cs.train_flops(cfg, 2, 16)


def test_train_cli(capsys):
    ttrain.main(["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "8", "--device",
                 "cpu"])
    assert "loss " in capsys.readouterr().out


# --------------------------------------------------------------------- #
# abstract inputs and the frontend
# --------------------------------------------------------------------- #
def meta_spec(tree):
    """Shapes and dtypes of a tree of ``meta`` tensors (no memory)."""
    out = {}
    for k, v in leaves(tree):
        assert v.device.type == "meta", k
        out[k] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    return out


def jax_spec(tree):
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in leaves(tree)}


def test_whisper_prefill_uses_true_decoder_length():
    """Twin of ``tests/test_launch_steps.py``'s: 448 text tokens and the
    whole audio, as the reference's specs."""
    cfg = tconfigs.get_config(ARCH)
    specs = tsteps.input_specs(cfg, "prefill_32k")
    assert specs["batch"]["tokens"].shape[1] == 448
    assert specs["batch"]["frames"].shape[1:] == (1500, 1280)
    want = jsteps.input_specs(jconfigs.get_config(ARCH), "prefill_32k")
    assert meta_spec(specs) == jax_spec(want)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_the_reference(shape):
    """Every leaf ``meta`` (no memory) with the reference's shape and
    dtype; the decode cache is ``init_cache``'s, cross keys and values
    included."""
    got = tsteps.input_specs(tconfigs.get_config(ARCH), shape)
    want = jsteps.input_specs(jconfigs.get_config(ARCH), shape)
    assert meta_spec(got) == jax_spec(want)


def test_abstract_params_and_opt_state_match_the_reference():
    cfg = jconfigs.get_config(ARCH)
    assert meta_spec(tsteps.abstract_params(port_cfg(cfg))) == jax_spec(
        jsteps.abstract_params(cfg))
    got, want = tsteps.abstract_opt_state(port_cfg(cfg)), jsteps.abstract_opt_state(cfg)
    for name in ("step", "m", "v"):
        assert meta_spec(getattr(got, name)) == jax_spec(getattr(want, name)), name


def test_abstract_cache_matches_init_cache():
    """Twin of ``test_decode_cache_matches_init_cache``: the abstract
    cache has a small real cache's structure, and its own shapes."""
    cfg = tconfigs.get_smoke_config(ARCH)
    specs = tsteps.abstract_cache(cfg, 128, 32768, False)
    real = tmodel.init_cache(cfg, 2, 16, device="cpu")
    assert [k for k, _ in leaves(specs)] == [k for k, _ in leaves(real)]
    assert meta_spec(specs) == jax_spec(jsteps.abstract_cache(jconfigs.get_smoke_config(ARCH),
                                                              128, 32768, False))


def test_frontend_matches_the_reference():
    for arch in (ARCH, "phi-3-vision-4.2b"):
        cfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
        pairs = [(tfrontend.vision_patch_spec, jfrontend.vision_patch_spec,
                  tfrontend.synth_vision_patches, jfrontend.synth_vision_patches)]
        if cfg.encoder_layers:
            pairs = [(tfrontend.audio_frame_spec, jfrontend.audio_frame_spec,
                      tfrontend.synth_audio_frames, jfrontend.synth_audio_frames)]
        for tspec, jspec, tsynth, jsynth in pairs:
            got, want = tspec(tcfg, 3), jspec(cfg, 3)
            assert got.device.type == "meta"
            assert (tuple(got.shape), str(got.dtype)) == (want.shape, "torch." + str(want.dtype))
            small, jsmall = tconfigs.get_smoke_config(arch), jconfigs.get_smoke_config(arch)
            np.testing.assert_array_equal(tsynth(small, 2, np.random.default_rng(3)),
                                          jsynth(jsmall, 2, np.random.default_rng(3)))
            np.testing.assert_array_equal(tsynth(small, 2), jsynth(jsmall, 2))
