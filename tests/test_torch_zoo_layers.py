"""The port's attention layers and blocks against the reference, on the
CPU, at the smoke configs of the six decoder-only attention
architectures and of xLSTM-350M and Zamba2-1.2B: GQA (plain, qk-norm,
window, softcap; decode past the window through the ring buffer), the
full-sequence MLA, ``block_forward`` for every ported kind (``dense``,
``moe`` with MLA and with GQA, ``attn``, ``attn_local``, ``attn_global``,
``mamba2``, ``shared_attn`` with the model's shared block, ``mlstm``,
``slstm``; with and without ``force_local``). The mixers alone are in
``tests/test_torch_ssm.py``; Whisper's ``enc`` and ``dec`` kinds and its
cross attention in ``tests/test_torch_whisper.py``.

The reference's parameters are carried across by ``params_from_jax``;
inputs are made with numpy from a seed. Bars: 1e-5 for the attention
layers in float32, 1e-4 / 3e-2 for blocks in float32 / bfloat16; in
bfloat16 the reference runs op by op (``jax.disable_jit()``), as in
``tests/test_torch_zoo.py``.
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
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import model as jmodel
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import config as tconfig
from repro_torch.models import model as tmodel

TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def port_cfg(cfg):
    """The same configuration as the port's own dataclass."""

    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        return v

    return tconfig.ModelConfig(
        **{f.name: conv(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    )


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


def reference(dtype):
    """The reference's mode for ``dtype``: op by op in bfloat16, as it
    comes in float32."""
    return jax.disable_jit() if dtype == "bfloat16" else contextlib.nullcontext()


@functools.cache
def model_pair(arch, dtype):
    cfg = jconfigs.get_smoke_config(arch).with_overrides(dtype=dtype)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return cfg, params, port


GQA_CASES = {
    "plain": ("phi3-mini-3.8b", {}),
    "qk_norm": ("qwen3-8b", {}),
    "window": ("gemma2-2b", {"window": 8}),
    "softcap": ("gemma2-2b", {}),
}


def layer_params(cfg, params, index):
    """Layer ``index``'s block parameters of the reference's stacked tree."""
    for (unit, count), g in zip(jmodel.scan_groups(cfg), params["groups"]):
        if index < len(unit) * count:
            up = jax.tree_util.tree_map(lambda a: a[index // len(unit)], g)
            return unit[index % len(unit)], up[f"b{index % len(unit)}"]
        index -= len(unit) * count
    raise IndexError(index)


@pytest.mark.parametrize("case", GQA_CASES)
def test_gqa_forward_matches_the_reference(case):
    arch, kw = GQA_CASES[case]
    cfg, params, _ = model_pair(arch, "float32")
    _, lp = layer_params(cfg, params, 0)
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, lp["mixer"]), "cpu")
    x = np.random.default_rng(2).standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    pos = np.arange(13)[None]
    want = jattn.gqa_forward(cfg, lp["mixer"], jnp.asarray(x), jnp.asarray(pos), **kw)
    got = tattn.gqa_forward(port_cfg(cfg), tp, torch.from_numpy(x), torch.from_numpy(pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [0, 8])
def test_gqa_decode_matches_the_reference_past_the_window(window):
    """Twelve decode positions (past a window of 8: the ring buffer's slot
    ``pos % window``), the caches carried by each package; the port's
    written in place."""
    cfg, params, _ = model_pair("gemma2-2b", "float32")
    _, lp = layer_params(cfg, params, 0)
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, lp["mixer"]), "cpu")
    s_cache = window or 12
    shape = (2, s_cache, cfg.num_kv_heads, cfg.head_dim)
    jk = jv = jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    xs = np.random.default_rng(3).standard_normal((12, 2, 1, cfg.d_model)).astype(np.float32)
    for pos in range(12):
        want, jk, jv = jattn.gqa_decode(cfg, lp["mixer"], jnp.asarray(xs[pos]), jk, jv,
                                        jnp.int32(pos), window=window)
        got, gk, gv = tattn.gqa_decode(port_cfg(cfg), tp, torch.from_numpy(xs[pos]), tk, tv,
                                       pos, window=window)
        assert gk is tk and gv is tv
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=f"pos {pos}")
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_forward_matches_the_reference(dtype):
    cfg, params, _ = model_pair("deepseek-v3-671b", dtype)
    _, lp = layer_params(cfg, params, 0)
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, lp["mixer"]), "cpu")
    x = np.random.default_rng(4).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    pos = np.arange(11)[None]
    with reference(dtype):
        want = jattn.mla_forward(cfg, lp["mixer"], jnp.asarray(x).astype(jdt), jnp.asarray(pos))
    got = tattn.mla_forward(port_cfg(cfg), tp, torch.from_numpy(x).to(tdt), torch.from_numpy(pos))
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype], atol=TOL[dtype])


BLOCKS = {  # kind: (arch, layer index)
    "dense": ("deepseek-v3-671b", 0),
    "moe-mla": ("deepseek-v3-671b", 1),
    "moe-gqa": ("phi3.5-moe-42b-a6.6b", 0),
    "attn": ("qwen3-8b", 0),
    "attn_local": ("gemma2-2b", 0),
    "attn_global": ("gemma2-2b", 1),
    "mamba2": ("zamba2-1.2b", 0),
    "shared_attn": ("zamba2-1.2b", 1),
    "mlstm": ("xlstm-350m", 0),
    "slstm": ("xlstm-350m", 1),
}


@pytest.mark.parametrize("force_local", [False, True], ids=["", "force_local"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("block", BLOCKS)
def test_block_forward_matches_the_reference(block, dtype, force_local):
    arch, index = BLOCKS[block]
    cfg, params, _ = model_pair(arch, dtype)
    kind, lp = layer_params(cfg, params, index)
    assert kind == block.split("-")[0]
    tp = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, lp), "cpu")
    shared = params.get("shared_block")
    tshared = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, shared), "cpu") if (
        shared is not None) else None
    x = np.random.default_rng(5).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    pos = np.arange(12)[None]
    with reference(dtype):
        want, waux = jblocks.block_forward(cfg, kind, lp, jnp.asarray(x).astype(jdt),
                                           jnp.asarray(pos), shared=shared,
                                           force_local=force_local)
    with torch.no_grad():
        got, gaux = tblocks.block_forward(port_cfg(cfg), kind, tp, torch.from_numpy(x).to(tdt),
                                          torch.from_numpy(pos), shared=tshared,
                                          force_local=force_local)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5, atol=1e-7)


