"""The port's serving path for DeepSeek-V3 (MLA decode, dense and MoE
layers) against the reference, on the CPU.

Most tests here run the reference's DeepSeek-V3 smoke config with both
layers dense (``moe.first_k_dense = 2``), so that the stacked layer group
runs with count 2; the reference's smoke config itself (its second layer
MoE) is served by the CLI test, and every architecture's smoke config by
``tests/test_torch_zoo.py``. The reference's ``init_params``
(``jax.random``) are carried across by ``params_from_jax``, and both
packages decode the same tokens at the same positions:

* float32: logits allclose at ``1e-4`` (the reference's own bar for the
  latent context) and greedy tokens from ``serve_batch`` equal;
* bfloat16: logits allclose at ``3e-2``. The two frameworks round the
  bfloat16 matmul outputs at other places, and the reference rounds the
  softmax weights to bfloat16 before the context product where the
  port's ``mla_flash_decode`` keeps them float32; that moves hidden
  values of magnitude ~1 by a few bfloat16 ulps (2^-7 each), and the
  logits with them.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.kernels import native
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import model as tmodel

ARCH = "deepseek-v3-671b"
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def dense_cfg(dtype="float32"):
    cfg = jconfigs.get_smoke_config(ARCH)
    return cfg.with_overrides(
        dtype=dtype, moe=dataclasses.replace(cfg.moe, first_k_dense=cfg.num_layers)
    )


def port_cfg(cfg):
    """The same configuration as the port's own dataclass."""
    from repro_torch.models import config as tconfig

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


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model_pair(request):
    cfg = dense_cfg(request.param)
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return request.param, cfg, params, port


def test_dense_config_runs_one_stacked_group_of_two():
    cfg = port_cfg(dense_cfg())
    assert tmodel.scan_groups(cfg) == [(("dense",), 2)]
    assert tmodel.layer_kinds(cfg) == ["dense", "dense"]


def test_params_from_jax_carries_every_leaf(model_pair):
    dtype, cfg, params, port = model_pair
    want = dict(leaves(jax.tree_util.tree_map(np.asarray, params)))
    got = dict(leaves(port))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), k
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32), err_msg=k)


def test_init_params_tree_matches_the_reference(model_pair):
    """The port's own random init: the reference's leaves, shapes and
    dtypes (MTP head included), from a generator on the CPU."""
    dtype, cfg, params, _ = model_pair
    want = {k: (v.shape, str(v.dtype)) for k, v in leaves(params)}
    got = {
        k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
        for k, v in leaves(tmodel.init_params(port_cfg(cfg), 0, device="cpu"))
    }
    assert got == want
    assert any(k.startswith("/mtp_block/") for k in got) and "/mtp_proj" in got


def test_init_params_is_seeded():
    cfg = port_cfg(dense_cfg())
    a, b, c = (tmodel.init_params(cfg, seed, device="cpu") for seed in (3, 3, 4))
    for (ka, va), (kb, vb), (_, vc) in zip(leaves(a), leaves(b), leaves(c)):
        assert ka == kb and torch.equal(va, vb)
    assert not torch.equal(a["embed"], c["embed"])


def test_init_cache_matches_the_reference(model_pair):
    dtype, cfg, _, _ = model_pair
    want = {k: (v.shape, str(v.dtype)) for k, v in leaves(jmodel.init_cache(cfg, 3, 21))}
    got = {
        k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
        for k, v in leaves(tmodel.init_cache(port_cfg(cfg), 3, 21, device="cpu"))
    }
    assert got == want
    assert all(
        not v.any() for _, v in leaves(tmodel.init_cache(port_cfg(cfg), 3, 21, device="cpu"))
    )


def test_decode_step_logits_match_the_reference(model_pair):
    """Ten positions of decode, the caches carried by each package."""
    dtype, cfg, params, port = model_pair
    B, S = 3, 12
    jcache = jmodel.init_cache(cfg, B, S)
    tcache = tmodel.init_cache(port_cfg(cfg), B, S, device="cpu")
    tokens = np.random.default_rng(1).integers(1, cfg.vocab_size, size=(B, 10)).astype(np.int32)
    for t in range(10):
        tok = tokens[:, t : t + 1]
        want, jcache = jmodel.decode_step(cfg, params, jcache, jnp.asarray(tok), jnp.int32(t))
        got, tcache = tmodel.decode_step(port_cfg(cfg), port, tcache, torch.from_numpy(tok), t)
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=TOL[dtype], atol=TOL[dtype], err_msg=f"pos {t}"
        )
    for (k, jc), (_, tc) in zip(leaves(jcache), leaves(tcache)):
        np.testing.assert_allclose(
            tc.float().numpy(), np.asarray(jc, np.float32), rtol=TOL[dtype], atol=TOL[dtype],
            err_msg=k,
        )


def test_decode_step_writes_the_cache_in_place():
    cfg = port_cfg(dense_cfg())
    params = tmodel.init_params(cfg, 0, device="cpu")
    cache = tmodel.init_cache(cfg, 2, 8, device="cpu")
    c = cache[0]["b0"]["c"]
    _, out = tmodel.decode_step(cfg, params, cache, torch.ones((2, 1), dtype=torch.int32), 5)
    assert out is cache and out[0]["b0"]["c"] is c
    written = c.abs().sum(dim=-1)  # (count, B, S)
    assert bool((written[:, :, 5] > 0).all()) and not written[:, :, :5].any()
    assert not written[:, :, 6:].any()


def test_mla_decode_context_matches_the_reference():
    """One MLA layer's output and caches, float32: the port's decode (its
    context through ``ops.mla_flash_decode``) against the reference's
    inline ``mla_decode``."""
    cfg = dense_cfg()
    m = cfg.mla
    jparams = jattn.init_mla(cfg, jax.random.PRNGKey(0))
    tparams = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(4)
    B, S, pos = 2, 32, 17
    x = (rng.standard_normal((B, 1, cfg.d_model)) * 0.1).astype(np.float32)
    cc = (rng.standard_normal((B, S, m.kv_lora_rank)) * 0.3).astype(np.float32)
    ck = (rng.standard_normal((B, S, m.qk_rope_head_dim)) * 0.3).astype(np.float32)
    want, wc, wk = jattn.mla_decode(
        cfg, jparams, jnp.asarray(x), jnp.asarray(cc), jnp.asarray(ck), jnp.int32(pos)
    )
    tc, tk = torch.from_numpy(cc.copy()), torch.from_numpy(ck.copy())
    got, gc, gk = tattn.mla_decode(port_cfg(cfg), tparams, torch.from_numpy(x), tc, tk, pos)
    assert gc is tc and gk is tk
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-5, atol=1e-6)


def test_unembed_in_blocks_equals_the_reference(monkeypatch):
    """The float32 logits over vocabulary blocks (a block size that does
    not divide the vocabulary) equal the reference's one product."""
    cfg = dense_cfg("bfloat16")
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    want = np.asarray(
        jmodel.unembed(cfg, jnp.asarray(emb).astype(jnp.bfloat16), jnp.asarray(x).astype(jnp.bfloat16))
    )
    monkeypatch.setattr(tcommon, "UNEMBED_CHUNK", 100)
    got = tcommon.unembed(
        port_cfg(cfg), torch.from_numpy(emb).to(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    )
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_serve_batch_tokens_equal_the_reference():
    cfg = dense_cfg()
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    kw = dict(requests=3, prompt_len=8, gen_len=10, seed=2)
    want = jserve.serve_batch(ARCH, cfg=cfg, params=params, **kw)
    native.reset_launches()
    got = tserve.serve_batch(ARCH, cfg=port_cfg(cfg), params=port, device="cpu", **kw)
    assert got["tokens"].shape == (3, 10)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["decode_s"] > 0 and got["tokens_per_s"] > 0
    assert not any(native.LAUNCHES.values())


def test_serve_batch_defaults_to_the_card(monkeypatch):
    assert inspect.signature(tserve.serve_batch).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.serve_batch(ARCH, cfg=port_cfg(dense_cfg()))


def test_get_config_equals_the_reference_field_by_field():
    want, got = jconfigs.get_config(ARCH), tconfigs.get_config(ARCH)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(w):
            assert dataclasses.asdict(g) == dataclasses.asdict(w), f.name
        else:
            assert g == w, f.name
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(tconfigs.get_smoke_config(ARCH)) == dataclasses.asdict(
        jconfigs.get_smoke_config(ARCH)
    )
    assert tconfigs.all_arch_ids() == jconfigs.all_arch_ids()
    for arch in ("whisper-large-v3", "phi-3-vision-4.2b"):
        assert dataclasses.asdict(tconfigs.get_config(arch)) == dataclasses.asdict(
            jconfigs.get_config(arch)), arch


def test_full_width_slice_is_the_three_dense_layers():
    """The full-width cut that ``chip_smoke.py`` serves: the first five
    layers, the checkpoint's three dense layers and two MoE layers, as one
    stacked unit; 54.6 GB of bf16 parameters (MTP head included)."""
    cfg = tconfigs.get_config(ARCH).with_overrides(num_layers=5)
    assert tmodel.scan_groups(cfg) == [(("dense", "dense", "dense", "moe", "moe"), 1)]
    m = cfg.mla
    assert (cfg.num_heads, m.q_lora_rank, m.kv_lora_rank, cfg.moe.d_ff_dense) == (
        128, 1536, 512, 18432)
    e = cfg.moe
    assert (e.num_experts, e.experts_per_token, e.num_shared_experts, e.d_ff_expert) == (
        256, 8, 1, 2048)
    assert tmodel.param_bytes(cfg) == 54_616_842_240
    assert tsteps.SHAPES["decode_32k"] == dict(kind="decode", seq=32768, batch=128)


def test_cli_serves_the_dense_smoke_config(capsys):
    """The CLI serves the reference's smoke config, its MoE layer included,
    and ``--full`` refuses a model larger than memory by its bytes."""
    tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--prompt-len", "4",
                 "--gen", "3"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out
    assert tmodel.layer_kinds(tconfigs.get_smoke_config(ARCH)) == ["dense", "moe"]
    with pytest.raises(MemoryError, match="bytes of bfloat16 parameters"):
        tserve.main(["--arch", ARCH, "--full", "--device", "cpu"])


def test_serve_batch_with_the_moe_layer_equals_the_reference():
    """The reference's smoke config (layer 1 MoE) in float32: greedy
    tokens from ``serve_batch`` equal."""
    cfg = jconfigs.get_smoke_config(ARCH).with_overrides(dtype="float32")
    params = jmodel.init_params(cfg, jax.random.PRNGKey(0))
    port = tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    kw = dict(requests=3, prompt_len=8, gen_len=10, seed=3)
    want = jserve.serve_batch(ARCH, cfg=cfg, params=params, **kw)
    got = tserve.serve_batch(ARCH, cfg=port_cfg(cfg), params=port, device="cpu", **kw)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_decode_step_is_greedy():
    cfg = port_cfg(dense_cfg())
    params = tmodel.init_params(cfg, 1, device="cpu")
    step = tsteps.make_decode_step(cfg)
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    nxt, _ = step(params, tmodel.init_cache(cfg, 2, 4, device="cpu"), tok, 0)
    logits, _ = tmodel.decode_step(cfg, params, tmodel.init_cache(cfg, 2, 4, device="cpu"), tok, 0)
    assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (2, 1)
    assert torch.equal(nxt[:, 0], logits[:, -1].argmax(-1).to(torch.int32))
