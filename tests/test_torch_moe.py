"""The port's MoE layer (``repro_torch.models.moe``) against the
reference's (``repro.models.moe``), on the CPU.

The reference's parameters (``init_moe``, ``jax.random``) are carried
across by ``params_from_jax``; inputs are made with numpy from a seed.
Bars: routing indices equal, gates and the auxiliary loss within 1e-6;
``moe_forward`` within 1e-5 in float32 and 3e-2 in bfloat16 (the two
frameworks round the bfloat16 products and activations at other places).
Then the twins of ``tests/test_moe.py``'s four single-device properties
and the combine's fixed order (expert parallelism: ``test_torch_ep.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import telemetry
from repro_torch.models import config as tconfig
from repro_torch.models import moe as tmoe
from repro_torch.models import model as tmodel

ARCHES = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")  # shared expert: DeepSeek
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def port_cfg(cfg):
    """The same configuration as the port's own dataclass."""

    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        return v

    return tconfig.ModelConfig(
        **{f.name: conv(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    )


def ref_cfg(arch, dtype="float32", **moe):
    cfg = jconfigs.get_smoke_config(arch).with_overrides(dtype=dtype)
    if moe:
        cfg = cfg.with_overrides(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def pair(cfg, seed=0):
    params = jmoe.init_moe(cfg, jax.random.PRNGKey(seed))
    return params, tmodel.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")


def inputs(cfg, shape, seed=1):
    x = np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    jdt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_route_matches_the_reference(arch, dtype):
    cfg = ref_cfg(arch, dtype)
    jp, tp = pair(cfg)
    xj, xt = inputs(cfg, (64,))
    wg, wi, wa = jmoe._route(cfg, jp["router"], xj)
    gg, gi, ga = tmoe._route(port_cfg(cfg), tp["router"], xt)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gg.numpy(), np.asarray(wg), rtol=1e-6, atol=1e-6)
    assert gg.dtype == torch.float32 and ga.dtype == torch.float32
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-6)


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_moe_forward_matches_the_reference(arch, dtype, shared):
    cfg = ref_cfg(arch, dtype, num_shared_experts=shared)
    jp, tp = pair(cfg)
    assert ("shared" in tp) == bool(shared)
    xj, xt = inputs(cfg, (3, 7))
    want, waux = jmoe.moe_forward(cfg, jp, xj)
    got, gaux = tmoe.moe_forward(port_cfg(cfg), tp, xt)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(f32(got), f32(want), rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHES)
def test_moe_apply_is_moe_forward(arch):
    cfg = ref_cfg(arch)
    jp, tp = pair(cfg)
    xj, xt = inputs(cfg, (2, 5))
    a, _ = tmoe.moe_apply(port_cfg(cfg), tp, xt)
    b, _ = tmoe.moe_forward(port_cfg(cfg), tp, xt)
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), np.asarray(jmoe.moe_apply(cfg, jp, xj)[0]),
                               rtol=1e-5, atol=1e-5)


def test_init_moe_tree_matches_the_reference():
    for arch in ARCHES:
        cfg = ref_cfg(arch, "bfloat16")
        want = jmoe.init_moe(cfg, jax.random.PRNGKey(0))
        gen = torch.Generator().manual_seed(0)
        got = tmoe.init_moe(port_cfg(cfg), gen)
        assert got.keys() == want.keys()
        for k in ("router", "w_gate", "w_up", "w_down"):
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype), k


# --- twins of tests/test_moe.py (the single-device properties) --------- #
@pytest.fixture()
def phi_cfg():
    return tconfigs.get_smoke_config("phi3.5-moe-42b-a6.6b").with_overrides(dtype="float32")


def test_router_topk_gates_normalised(phi_cfg):
    params = tmoe.init_moe(phi_cfg, torch.Generator().manual_seed(0))
    tokens = torch.randn((32, phi_cfg.d_model), generator=torch.Generator().manual_seed(1))
    gates, idx, aux = tmoe._route(phi_cfg, params["router"], tokens)
    assert tuple(gates.shape) == (32, phi_cfg.moe.experts_per_token)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert int(idx.max()) < phi_cfg.moe.num_experts
    assert float(aux) > 0.0


def test_dropless_moe_all_tokens_processed(phi_cfg):
    """Every token's output is a gate-weighted mix: never zero unless the
    inputs are (no token dropping in the single-device path)."""
    params = tmoe.init_moe(phi_cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 8, phi_cfg.d_model), generator=torch.Generator().manual_seed(2))
    y, aux = tmoe.moe_forward(phi_cfg, params, x)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    assert float(y.abs().sum(-1).min()) > 0.0


def test_moe_matches_explicit_loop(phi_cfg):
    """The sorted dispatch == a naive per-expert loop over the tokens."""
    cfg = phi_cfg.with_overrides(moe=tconfig.MoEConfig(
        num_experts=4, experts_per_token=2, d_ff_expert=32))
    params = tmoe.init_moe(cfg, torch.Generator().manual_seed(3))
    x = torch.randn((1, 6, cfg.d_model), generator=torch.Generator().manual_seed(4))
    y, _ = tmoe.moe_forward(cfg, params, x)

    tokens = x.reshape(-1, cfg.d_model)
    gates, idx, _ = tmoe._route(cfg, params["router"], tokens)
    want = torch.zeros_like(tokens)
    for t in range(tokens.shape[0]):
        for j in range(cfg.moe.experts_per_token):
            e = int(idx[t, j])
            up = tokens[t] @ params["w_up"][e]
            gate = tokens[t] @ params["w_gate"][e]
            h = torch.nn.functional.silu(gate) * up
            want[t] += float(gates[t, j]) * (h @ params["w_down"][e])
    np.testing.assert_allclose(y.reshape(-1, cfg.d_model).numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)


def test_shared_expert_added(phi_cfg):
    cfg2 = phi_cfg.with_overrides(moe=tconfig.MoEConfig(
        num_experts=4, experts_per_token=2, d_ff_expert=32, num_shared_experts=2))
    params = tmoe.init_moe(cfg2, torch.Generator().manual_seed(0))
    assert "shared" in params and tuple(params["shared"]["w_up"].shape) == (cfg2.d_model, 64)
    x = torch.randn((1, 4, cfg2.d_model), generator=torch.Generator().manual_seed(6))
    y, _ = tmoe.moe_forward(cfg2, params, x)
    assert bool(torch.isfinite(y).all())


# --- what the port's design adds ----------------------------------------- #
def test_experts_without_rows_are_never_read(phi_cfg):
    """An expert that no token chose is not read: NaN weights there leave
    the output finite and unchanged."""
    params = tmoe.init_moe(phi_cfg, torch.Generator().manual_seed(0))
    # One token picks 2 of the 4 experts: two are left without rows.
    x = torch.randn((1, 1, phi_cfg.d_model), generator=torch.Generator().manual_seed(7))
    y, _ = tmoe.moe_forward(phi_cfg, params, x)
    _, idx, _ = tmoe._route(phi_cfg, params["router"], x.reshape(-1, phi_cfg.d_model))
    unused = sorted(set(range(phi_cfg.moe.num_experts)) - set(idx.flatten().tolist()))
    assert len(unused) == 2
    poisoned = dict(params)
    for k in ("w_gate", "w_up", "w_down"):
        poisoned[k] = params[k].clone()
        poisoned[k][unused] = float("nan")
    y2, _ = tmoe.moe_forward(phi_cfg, poisoned, x)
    assert torch.equal(y, y2)


def test_combine_sums_each_tokens_copies_in_expert_order():
    """The combine adds a token's k copies one after another in ascending
    expert order, in the output's dtype (the reference's scatter-add
    order), from zero: bfloat16 results equal that sum exactly, and a
    second call is bit-identical."""
    cfg = port_cfg(ref_cfg("deepseek-v3-671b", "bfloat16", num_shared_experts=0))
    params = tmoe.init_moe(cfg, torch.Generator().manual_seed(1))
    x = torch.randn((2, 5, cfg.d_model), generator=torch.Generator().manual_seed(8))
    x = x.to(torch.bfloat16)
    y, _ = tmoe.moe_forward(cfg, params, x)
    assert torch.equal(y, tmoe.moe_forward(cfg, params, x)[0])
    tokens = x.reshape(-1, cfg.d_model)
    gates, idx, _ = tmoe._route(cfg, params["router"], tokens)
    one = torch.tensor([1], dtype=torch.int32)
    for t in range(tokens.shape[0]):
        acc = torch.zeros((cfg.d_model,), dtype=torch.bfloat16)
        for j in torch.argsort(idx[t]).tolist():
            e = int(idx[t, j])
            expert = {w: params[w][e : e + 1] for w in ("w_gate", "w_up", "w_down")}
            out = tmoe._expert_ffn(cfg, expert, tokens[t : t + 1], one)[0]
            acc = acc + out * gates[t, j].to(torch.bfloat16)
        assert torch.equal(y.reshape(-1, cfg.d_model)[t], acc), t


def test_moe_forward_reads_nothing_to_the_host(phi_cfg, monkeypatch):
    """The group offsets stay on the device: no ``tolist`` or ``item``, and
    the call goes through a telemetry session's ``moe_forward`` hook."""
    params = tmoe.init_moe(phi_cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 3, phi_cfg.d_model), generator=torch.Generator().manual_seed(9))
    reads = []
    for name in ("tolist", "item", "__int__", "__bool__"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda t, *a, _n=name, _r=real: reads.append(_n) or _r(t, *a))

    class Session:
        profile_kernels = True
        calls = []

        def profile_call(self, name, fn, *args, **kwargs):
            self.calls.append(name)
            return fn(*args, **kwargs)

    session = Session()
    with telemetry.active(session):
        y, _ = tmoe.moe_forward(phi_cfg, params, x)
    monkeypatch.undo()
    assert session.calls == ["moe_forward"]
    assert reads == []
    assert bool(torch.isfinite(y).all())

