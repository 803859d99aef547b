"""The port's expert parallelism (``repro_torch.models.moe.moe_forward_ep``)
against the reference's bodies, on the CPU.

Spawned gloo worlds of 2 and 4 ranks run every case of
``torch_worlds.ep_cases()``: the meshes (1, 2), (2, 2) and (1, 4) with
``ep_axis="model"`` and (2, 2) with the composite ``("data", "model")``;
both combines (``psum`` and ``a2a``); capacity factors 8 (no drop) and
1.25 (drops); both MoE smoke configs in float32 (DeepSeek-V3's with its
shared expert). A subprocess runs the reference's ``_moe_local_body`` /
``_moe_local_body_a2a`` under its ``_shard_map`` with ``moe_forward_ep``'s
specs on 4 forced host devices, on the same numpy inputs. Bars: the
assembled ``y`` within 1e-5, ``aux`` within 1e-6, and the gradients of
``sum(y * ct) + aux`` (each parameter's summed over the batch axes, ``x``'s
assembled from the batch blocks) within 1e-5 of a leaf's largest. Every
drop case differs from its dropless twin by more than 0.5 on both sides.
Each rank's replicated outputs and gradients equal its ep peers' bit for
bit.

Then, in this process on a gloo world of one: the twin of
``tests/test_moe.py::test_ep_path_matches_single_device``, ``moe_apply``
dispatching on ``cfg.ep_axis``, ``serve_batch`` and a train step with
``ep_axis`` set, and the errors (no registered mesh, an ep axis out of the
mesh's order).
"""

import dataclasses
import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_worlds as W
from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch.configs import get_smoke_config
from repro_torch.data import TokenPipeline
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import model as M
from repro_torch.models import moe as tmoe
from repro_torch.optim import adamw_init

CASES = W.ep_cases()
IDS = [W.case_key(c) for c in CASES]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """``(reference, port)``: the reference's arrays by case key, and the
    port's per-rank arrays by world size."""
    out = tmp_path_factory.mktemp("ep")
    ref_file = out / "reference.npz"
    ref = W.start_reference("ep", ref_file)
    port = {}
    try:
        for world in (2, 4):
            cases = [c for c in CASES if np.prod(c["mesh"]) == world]
            (out / str(world)).mkdir()
            W.spawn_world(W.ep_rank, world, cases, str(out / str(world)))
            port[world] = [dict(np.load(out / str(world) / f"rank{r}.npz"))
                           for r in range(world)]
    finally:
        W.finish_reference(ref)
    return dict(np.load(ref_file)), port


def assemble(case, ranks):
    """The port's ``y``, ``aux`` and gradients over the whole batch and
    expert stack: ``y`` and ``x``'s gradient from the batch blocks, each
    parameter's gradient summed over the batch axes (expert stacks block by
    block along the ep axes). Checks that ep peers hold equal replicated
    values."""
    key = W.case_key(case)
    shape = case["mesh"]
    axes = W.ep_axes(case)
    sizes = dict(zip(W.MESH_AXES, shape))
    by = {}  # (batch index, ep index) -> rank's arrays
    for rank, arrays in enumerate(ranks):
        coords = dict(zip(W.MESH_AXES, W.rank_coords(rank, shape)))
        e = 0
        for a in axes:
            e = e * sizes[a] + coords[a]
        b = 0 if "data" in axes else coords["data"]
        by[b, e] = {k[len(key) + 1:]: v for k, v in arrays.items() if k.startswith(key + "/")}
    n_b = 1 if "data" in axes else sizes["data"]
    n_e = len(ranks) // n_b
    replicated = ["y", "aux", "g/x", "g/router"] + [
        k for k in by[0, 0] if k.startswith("g/shared/")]
    for b in range(n_b):
        for e in range(1, n_e):
            for k in replicated:
                np.testing.assert_array_equal(by[b, e][k], by[b, 0][k], err_msg=f"{key} {k}")
    out = {
        "y": np.concatenate([by[b, 0]["y"] for b in range(n_b)]),
        "aux": by[0, 0]["aux"],
        "g/x": np.concatenate([by[b, 0]["g/x"] for b in range(n_b)]),
    }
    for k in by[0, 0]:
        if not k.startswith("g/") or k == "g/x":
            continue
        if k in replicated:
            out[k] = sum(by[b, 0][k] for b in range(n_b))
        else:  # an expert stack
            out[k] = np.concatenate([sum(by[b, e][k] for b in range(n_b)) for e in range(n_e)])
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ep_matches_the_reference_bodies(results, case):
    ref_all, port = results
    key = W.case_key(case)
    got = assemble(case, port[int(np.prod(case["mesh"]))])
    want = {k[len(key) + 1:]: v for k, v in ref_all.items() if k.startswith(key + "/")}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["aux"], want["aux"], rtol=1e-6, atol=1e-6)
    for k in want:
        if k.startswith("g/"):
            scale = np.abs(want[k]).max()
            err = np.abs(got[k] - want[k]).max()
            assert err <= 1e-5 * scale, f"{k}: {err} of {scale}"
    if case["cf"] != W.EP_CFS[0]:  # the drop case differs from the dropless one
        dropless = W.dropless_key(case)
        ref_gap = np.abs(want["y"] - ref_all[f"{dropless}/y"]).max()
        port_gap = np.abs(got["y"] - assemble(dict(case, cf=W.EP_CFS[0]),
                                              port[int(np.prod(case["mesh"]))])["y"]).max()
        assert ref_gap > 0.5 and port_gap > 0.5, (ref_gap, port_gap)


@pytest.mark.parametrize("world", (2, 4))
def test_whole_stacks_are_refused_past_one_ep_rank(results, world):
    """Every rank of a world with more than one ep rank refuses the whole
    expert stacks in place of its block."""
    for arrays in results[1][world]:
        assert "this rank's block" in str(arrays["refused"])


# --------------------------------------------------------------------- #
# a world of one, in this process
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    store = tmp_path_factory.mktemp("store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=W.COLLECTIVE_S))
    mesh = make_test_mesh(1, 1, device_type="cpu")
    tmoe.set_ep_mesh(mesh)
    yield mesh
    tmoe.set_ep_mesh(None)
    dist.destroy_process_group()


def _port_cfg(cfg):
    from repro_torch.models import config as tconfig

    def conv(v):
        if dataclasses.is_dataclass(v):
            return getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
        return v

    return tconfig.ModelConfig(**{f.name: conv(getattr(cfg, f.name))
                                  for f in dataclasses.fields(cfg)})


@pytest.mark.parametrize("combine", W.EP_COMBINES)
@pytest.mark.parametrize("arch", W.EP_ARCHES)
def test_ep_path_matches_single_device(world_of_one, arch, combine):
    """The twin of the reference's test: on a mesh of one with capacity 8
    (no drop) ``moe_forward_ep`` equals ``moe_forward`` on the reference's
    parameters (2e-4, the reference's bar; the port's own ``moe_forward``
    1e-6, the auxiliary loss equal)."""
    cfg = jconfigs.get_smoke_config(arch).with_overrides(dtype="float32")
    params = jmoe.init_moe(cfg, jax.random.PRNGKey(0))
    x = np.random.default_rng(5).standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    y_ref, _ = jmoe.moe_forward(cfg, params, x)
    tp = M.params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tcfg = _port_cfg(cfg)
    y_plain, aux_plain = tmoe.moe_forward(tcfg, tp, torch.from_numpy(x))
    y_ep, aux_ep = tmoe.moe_forward_ep(
        tcfg.with_overrides(ep_axis="model", ep_capacity_factor=8.0, ep_combine=combine),
        tp, torch.from_numpy(x))
    np.testing.assert_allclose(y_ep.numpy(), np.asarray(y_ref), rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y_ep, y_plain, rtol=1e-6, atol=1e-6)
    assert torch.equal(aux_ep, aux_plain)


def test_moe_apply_dispatches_on_ep_axis(world_of_one, monkeypatch):
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_overrides(dtype="float32")
    params = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(1))
    called = []
    real = tmoe._moe_local_body

    def body(*args):
        called.append("body")
        return real(*args)

    monkeypatch.setattr(tmoe, "_moe_local_body", body)
    tmoe.moe_apply(cfg, params, x)
    assert called == []
    tmoe.moe_apply(cfg.with_overrides(ep_axis="model"), params, x)
    assert called == ["body"]


def test_serve_and_train_run_with_ep_axis(world_of_one):
    """On a mesh of one, ``serve_batch`` and a train step run unchanged
    with ``ep_axis`` set: at capacity 8 the tokens equal the dropless
    run's, the step's loss is within 1e-6 of it and every gradient within
    1e-5 of a leaf's largest."""
    base = get_smoke_config("deepseek-v3-671b").with_overrides(dtype="float32")
    ep = base.with_overrides(ep_axis="model", ep_capacity_factor=8.0)
    served = [serve_mod.serve_batch("deepseek-v3-671b", cfg=c, params=M.init_params(base, 3, device="cpu"),
                                    device="cpu", requests=2, prompt_len=6, gen_len=4)["tokens"]
              for c in (base, ep)]
    np.testing.assert_array_equal(served[0], served[1])
    batch = {k: torch.from_numpy(v) for k, v in TokenPipeline(base, 2, 12, seed=2).next_batch().items()}
    losses, grads = [], []
    for c in (base, ep):
        p = M.init_params(base, 3, device="cpu")
        _, g_c = loss_and_grads(c, p, batch, remat=False)[::2]
        grads.append(list(M._leaves(g_c)))
        _, _, metrics = make_train_step(c, lr=1e-3, remat=False)(p, adamw_init(p), batch)
        losses.append(float(metrics["loss"]))
    assert abs(losses[0] - losses[1]) <= 1e-6 * abs(losses[0])
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_moe_forward_ep_needs_a_mesh():
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_overrides(
        dtype="float32", ep_axis="model")
    params = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    saved = tmoe._EP
    tmoe.set_ep_mesh(None)
    try:
        with pytest.raises(RuntimeError, match="no EP mesh registered"):
            tmoe.moe_apply(cfg, params, torch.zeros((1, 2, cfg.d_model)))
    finally:
        tmoe._EP = saved


def test_moe_forward_ep_needs_the_local_expert_block(world_of_one):
    """Local in, local out: on a mesh of one the block is the whole stack,
    so half of it is refused."""
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_overrides(
        dtype="float32", ep_axis="model")
    params = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    half = {k: v[: cfg.moe.num_experts // 2] if k.startswith("w_") else v
            for k, v in params.items()}
    with pytest.raises(ValueError, match="this rank's block"):
        tmoe.moe_forward_ep(cfg, half, torch.zeros((1, 2, cfg.d_model)))


def test_registering_a_mesh_again_builds_no_group(world_of_one, monkeypatch):
    """The whole mesh's group is built once for the world; registering the
    mesh again, or a mesh of the same layout, reuses it."""
    built = tmoe._group(world_of_one, ("data", "model"))
    monkeypatch.setattr(dist, "new_subgroups_by_enumeration",
                        lambda *a, **k: pytest.fail("a group was built again"))
    tmoe.set_ep_mesh(world_of_one)
    tmoe.set_ep_mesh(make_test_mesh(1, 1, device_type="cpu"))
    tmoe.set_ep_mesh(world_of_one)
    assert tmoe._group(world_of_one, ("data", "model")) is built
    assert tmoe._group(world_of_one, ("model",)) is world_of_one.get_group("model")


def test_ep_axis_must_follow_the_mesh(world_of_one):
    cfg = get_smoke_config("phi3.5-moe-42b-a6.6b").with_overrides(dtype="float32")
    params = tmoe.init_moe(cfg, torch.Generator().manual_seed(0))
    x = torch.zeros((1, 2, cfg.d_model))
    for bad in (("model", "data"), "pod"):
        with pytest.raises(ValueError, match="in its order"):
            tmoe.moe_forward_ep(cfg.with_overrides(ep_axis=bad), params, x)
