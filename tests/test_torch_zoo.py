"""The port's model zoo against the reference, on the CPU: the six
decoder-only attention architectures (DeepSeek-V3, Phi-3.5-MoE,
Qwen3-8B, Phi-3-mini, Minitron-4B, Gemma2-2B) at their smoke configs.
``tests/test_torch_zoo_ssm.py`` runs the same tests on the SSM one
(xLSTM-350M) and the hybrid one (Zamba2-1.2B), and
``tests/test_torch_whisper.py`` / ``test_torch_vision.py`` on Whisper-large-v3
and Phi-3-vision-4.2B.

The reference's ``init_params`` (``jax.random``) are carried across by
``params_from_jax``, inputs are made with numpy from a seed, and both
packages run the same tokens:

* configs field by field, the scan groups, the parameter and cache trees
  leaf by leaf (the caches' initial values too: the xLSTM stabiliser
  ``m`` starts at -1e30) (also at full width, by shapes only; the layers and
  blocks are in ``tests/test_torch_zoo_layers.py``);
* ``forward`` and ``decode_step`` logits: 1e-4 in float32, 3e-2 in
  bfloat16; ``serve_batch`` greedy tokens equal in float32, and the CLI;
* the twin of ``tests/test_decode_consistency.py``: ``forward`` against
  token-by-token decode within 1e-3 x max(|logits|, 1), Gemma2's ring
  buffer past its window included.

In bfloat16 the reference is run op by op (``jax.disable_jit()``): its
jitted layer scan keeps some bfloat16 intermediates in float32 inside a
fusion, and at a near-tie the MoE router then picks another expert. On
the Phi-3.5-MoE smoke config and these tokens the reference's jitted and
op-by-op forwards differ by 0.40 in the logits for that reason. The port
rounds at every operation, as the op-by-op run does.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.kernels import native
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as tcommon
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel

ARCHES = ("deepseek-v3-671b", "phi3.5-moe-42b-a6.6b", "qwen3-8b", "phi3-mini-3.8b",
          "minitron-4b", "gemma2-2b")
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
S = 14  # past the Gemma2 smoke config's window of 8


def port_cfg(cfg):
    """The same configuration as the port's own dataclass."""

    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        return v

    return tconfig.ModelConfig(
        **{f.name: conv(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    )


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def spec(tree):
    return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in leaves(tree)}


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@functools.cache
def model_pair(arch, dtype):
    cfg = jconfigs.get_smoke_config(arch).with_overrides(dtype=dtype)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, port


@functools.cache
def tokens(vocab, batch=2, seq=S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(batch, seq)).astype(np.int32)


def reference(dtype):
    """The reference's mode for ``dtype``: op by op in bfloat16 (see the
    module docstring), as it comes in float32."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


@functools.cache
def reference_run(arch, dtype):
    """The reference's forward logits and its decode logits at every
    position of ``tokens``."""
    cfg, params, _ = model_pair(arch, dtype)
    toks = jnp.asarray(tokens(cfg.vocab_size))
    with reference(dtype):
        fwd = jax.jit(functools.partial(jmodel.forward, cfg)) if dtype == "float32" else (
            functools.partial(jmodel.forward, cfg))
        full, aux = fwd(params, toks)
        step = jax.jit(functools.partial(jmodel.decode_step, cfg)) if dtype == "float32" else (
            functools.partial(jmodel.decode_step, cfg))
        cache = jmodel.init_cache(cfg, toks.shape[0], S + 2)
        dec = []
        for t in range(S):
            lg, cache = step(params, cache, toks[:, t : t + 1], jnp.int32(t))
            dec.append(np.asarray(lg[:, 0]))
    return np.asarray(full), float(aux), np.stack(dec, axis=1)


@functools.cache
def port_run(arch, dtype):
    cfg, _, port = model_pair(arch, dtype)
    pc = port_cfg(cfg)
    toks = torch.from_numpy(tokens(cfg.vocab_size))
    with torch.no_grad():
        full, aux = tmodel.forward(pc, port, toks)
        cache = tmodel.init_cache(pc, toks.shape[0], S + 2, device="cpu")
        dec = []
        for t in range(S):
            lg, cache = tmodel.decode_step(pc, port, cache, toks[:, t : t + 1], t)
            dec.append(lg[:, 0])
    return full, float(aux), torch.stack(dec, dim=1)


# --------------------------------------------------------------------- #
# configs, groups, trees
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHES)
def test_get_config_equals_the_reference_field_by_field(arch):
    for getter in ("get_config", "get_smoke_config"):
        want, got = getattr(jconfigs, getter)(arch), getattr(tconfigs, getter)(arch)
        assert type(got).__module__ == "repro_torch.models.config"
        for f in dataclasses.fields(want):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if dataclasses.is_dataclass(w):
                assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
            else:
                assert g == w, f.name
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("arch", ARCHES)
def test_scan_groups_match_the_reference(arch):
    for cfg in (jconfigs.get_config(arch), jconfigs.get_smoke_config(arch)):
        assert tmodel.scan_groups(port_cfg(cfg)) == jmodel.scan_groups(cfg)
        assert tmodel.layer_kinds(port_cfg(cfg)) == jmodel.layer_kinds(cfg)


@pytest.mark.parametrize("arch", ARCHES)
def test_params_from_jax_carries_every_leaf(arch):
    cfg, params, port = model_pair(arch, "bfloat16")
    want = dict(leaves(jax.tree_util.tree_map(np.asarray, params)))
    got = dict(leaves(port))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert (tuple(got[k].shape), str(got[k].dtype).removeprefix("torch.")) == (
            w.shape, str(w.dtype)), k
        np.testing.assert_array_equal(f32(got[k]), np.asarray(w, np.float32), err_msg=k)


@pytest.mark.parametrize("arch", ARCHES)
def test_init_params_tree_matches_the_reference(arch):
    """The port's own random init: the reference's leaves, shapes and
    dtypes, from a generator on the CPU, seeded."""
    cfg, params, _ = model_pair(arch, "bfloat16")
    a = tmodel.init_params(port_cfg(cfg), 3, device="cpu")
    assert spec(a) == {k: (v.shape, str(v.dtype)) for k, v in leaves(params)}
    b = tmodel.init_params(port_cfg(cfg), 3, device="cpu")
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(leaves(a), leaves(b)))


@pytest.mark.parametrize("arch", ARCHES)
def test_full_width_trees_match_the_reference_by_shape(arch):
    """At the published widths and depth, by shapes only (no memory): the
    parameter tree equals the reference's ``eval_shape`` leaf by leaf, and
    ``param_bytes`` is its size."""
    cfg = jconfigs.get_config(arch)
    want = {k: (v.shape, str(v.dtype)) for k, v in leaves(jsteps.abstract_params(cfg))}
    got = spec(tmodel._draw_params(port_cfg(cfg), tcommon.SHAPES_ONLY))
    assert got == want
    assert tmodel.param_bytes(port_cfg(cfg)) == sum(
        int(np.prod(v.shape)) * v.dtype.itemsize for _, v in leaves(jsteps.abstract_params(cfg)))


@pytest.mark.parametrize("long_mode", [False, True], ids=["full", "long"])
@pytest.mark.parametrize("arch", ARCHES)
def test_init_cache_matches_the_reference(arch, long_mode):
    cfg = jconfigs.get_smoke_config(arch)
    want = dict(leaves(jmodel.init_cache(cfg, 3, 21, long_mode=long_mode)))
    got = tmodel.init_cache(port_cfg(cfg), 3, 21, long_mode=long_mode, device="cpu")
    assert spec(got) == {k: (v.shape, str(v.dtype)) for k, v in want.items()}
    for k, v in leaves(got):
        np.testing.assert_array_equal(f32(v), f32(want[k]), err_msg=k)


def test_init_params_refuses_a_model_larger_than_memory():
    cfg = tconfigs.get_config("deepseek-v3-671b")
    with pytest.raises(MemoryError, match=f"needs {tmodel.param_bytes(cfg)} bytes"):
        tmodel.init_params(cfg, 0, device="cpu")


# --------------------------------------------------------------------- #
# the whole stack
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_forward_matches_the_reference(arch, dtype):
    want, waux, _ = reference_run(arch, dtype)
    got, gaux, _ = port_run(arch, dtype)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])
    # The MoE layers' load-balance loss counts each token's top-1 expert:
    # in bfloat16 a near-tie between a token's first two experts moves it.
    np.testing.assert_allclose(gaux, waux, rtol=1e-5 if dtype == "float32" else TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_decode_step_matches_the_reference(arch, dtype):
    _, _, want = reference_run(arch, dtype)
    _, _, got = port_run(arch, dtype)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_matches_forward(arch):
    """Twin of ``tests/test_decode_consistency.py::test_decode_matches_forward``
    (float32; teacher-forced forward against token-by-token decode)."""
    full, _, dec = port_run(arch, "float32")
    err = (dec - full).abs().max().item()
    scale = full.abs().max().item()
    assert err < 1e-3 * max(scale, 1.0), f"{arch}: {err} vs scale {scale}"


def test_sliding_window_ring_buffer():
    """Twin of the reference's test: Gemma2's local layers decode past the
    window through the ring buffer and match windowed full attention."""
    cfg = tconfigs.get_smoke_config("gemma2-2b").with_overrides(dtype="float32")
    assert cfg.sliding_window == 8
    params = tmodel.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(tokens(cfg.vocab_size, batch=1, seed=5))
    with torch.no_grad():
        full, _ = tmodel.forward(cfg, params, toks)
        cache = tmodel.init_cache(cfg, 1, S + 2, device="cpu")
        assert cache[0]["b0"]["k"].shape[2] == cfg.sliding_window
        outs = []
        for t in range(S):
            lg, cache = tmodel.decode_step(cfg, params, cache, toks[:, t : t + 1], t)
            outs.append(lg[:, 0])
    err = (torch.stack(outs, dim=1) - full).abs().max().item()
    assert err < 1e-3, err


def test_long_mode_forces_local():
    """Twin of the reference's test: under ``long_mode`` the global layers'
    caches hold the window only, and ``force_local`` decode matches the
    reference's."""
    cfg = tconfigs.get_smoke_config("gemma2-2b")
    cache_long = tmodel.init_cache(cfg, 1, 64, long_mode=True, device="cpu")
    cache_full = tmodel.init_cache(cfg, 1, 64, long_mode=False, device="cpu")
    assert cache_long[0]["b1"]["k"].shape[2] == cfg.sliding_window
    assert cache_full[0]["b1"]["k"].shape[2] == 64

    jcfg, params, port = model_pair("gemma2-2b", "float32")
    toks = tokens(jcfg.vocab_size)
    jstep = jax.jit(jsteps.make_decode_step(jcfg, long_mode=True))
    tstep = tsteps.make_decode_step(port_cfg(jcfg), long_mode=True)
    jcache = jmodel.init_cache(jcfg, 2, S + 2, long_mode=True)
    tcache = tmodel.init_cache(port_cfg(jcfg), 2, S + 2, long_mode=True, device="cpu")
    for t in range(S):
        want, jcache = jstep(params, jcache, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
        got, tcache = tstep(port, tcache, torch.from_numpy(toks[:, t : t + 1]), t)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"pos {t}")
    for (k, jc), (_, tc) in zip(leaves(jcache), leaves(tcache)):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_step_matches_the_reference(arch):
    """``make_prefill_step``: the last position's float32 logits of
    ``forward``, the reference's within 1e-4."""
    cfg, params, port = model_pair(arch, "float32")
    toks = tokens(cfg.vocab_size)
    want = jax.jit(jsteps.make_prefill_step(cfg))(params, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        got = tsteps.make_prefill_step(port_cfg(cfg))(port, {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == (2, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, port_run(arch, "float32")[0][:, -1])


@pytest.mark.parametrize("arch", ARCHES)
def test_serve_batch_tokens_equal_the_reference(arch):
    cfg, params, port = model_pair(arch, "float32")
    kw = dict(requests=3, prompt_len=8, gen_len=10, seed=2)
    want = jserve.serve_batch(arch, cfg=cfg, params=params, **kw)
    native.reset_launches()
    got = tserve.serve_batch(arch, cfg=port_cfg(cfg), params=port, device="cpu", **kw)
    assert got["tokens"].shape == (3, 10)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert not any(native.LAUNCHES.values())


@pytest.mark.parametrize("arch", ARCHES)
def test_cli_serves_the_smoke_config(arch, capsys):
    tserve.main(["--arch", arch, "--device", "cpu", "--requests", "2", "--prompt-len", "4",
                 "--gen", "3"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out
