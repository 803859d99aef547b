"""The port's sharding rules (``repro_torch.models.sharding``) and meshes
(``repro_torch.launch.mesh``) against the reference's, on the CPU.

* Every leaf's ``param_spec`` equals the reference's over the ten full
  configs (the reference's ``jax.eval_shape(init_params)`` tree beside the
  port's ``launch.steps.abstract_params`` on ``meta``), on fake meshes
  (data=16, model=16) and (pod=2, data=16, model=16), with ``ep_axis``
  ``None``, ``"model"`` and ``("data", "model")`` and ``fsdp`` off and on;
  the moments' ``zero_spec`` with them (``shard_opt_state``).
* ``cache_spec`` on each decode shape's abstract cache (``decode_32k``;
  ``long_500k`` with ``seq_shard`` where the config supports it) and
  ``batch_spec`` on each training and prefill batch.
* The twins of ``tests/test_sharding.py``'s guard, rule and cache tests,
  its hypothesis property among them.
* On a spawned gloo world of 4 as a (2, 2) mesh, each rank's ``place``d
  block equals the slice that the reference's
  ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives the
  device at its coordinate (a reference subprocess on 4 host devices).
* The meshes' and placements' refusals: a world of the wrong size, a
  composite axis out of the mesh's order.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import PartitionSpec as JP

import torch_worlds as W
from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.models import sharding as jsh
from repro_torch import configs as tconfigs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models import sharding as sh
from repro_torch.models.sharding import P
from repro_torch.tree import map_with_path

ARCHES = tuple(jconfigs.all_arch_ids())


class FakeMesh:
    """Mesh stand-in with arbitrary axis sizes, as the reference's tests'."""

    def __init__(self, **axes):
        self.shape = axes


MESHES = {"16x16": dict(data=16, model=16), "2x16x16": dict(pod=2, data=16, model=16)}
EP_AXES = {"none": None, "model": "model", "data+model": ("data", "model")}


@functools.cache
def ref_leaves(arch):
    """``[(path names, shape)]`` of the reference's full parameter tree."""
    tree = jax.eval_shape(lambda: jmodel.init_params(jconfigs.get_config(arch),
                                                     jax.random.PRNGKey(0)))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(jsh._path_names(path)), tuple(leaf.shape)) for path, leaf in flat]


def port_leaves(tree):
    out = []
    map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out


@functools.cache
def port_params(arch):
    return port_leaves(tsteps.abstract_params(tconfigs.get_config(arch)))


def test_the_trees_and_paths_agree():
    for arch in ARCHES:
        got = [(tuple(sh._path_names(p)), tuple(t.shape)) for p, t in port_params(arch)]
        assert got == ref_leaves(arch), arch


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("ep", list(EP_AXES), ids=list(EP_AXES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHES)
def test_param_specs_match_the_reference(arch, mesh, ep, fsdp):
    fake = FakeMesh(**MESHES[mesh])
    over = dict(ep_axis=EP_AXES[ep], fsdp=fsdp)
    rcfg = jconfigs.get_config(arch).with_overrides(**over)
    tcfg = tconfigs.get_config(arch).with_overrides(**over)
    leaves = port_params(arch)
    opt = sh.shard_opt_state(fake, tcfg, tsteps.abstract_params(tconfigs.get_config(arch)))
    moments = [s for _, s in port_leaves(opt.m)]
    assert opt.step.spec == P()
    for (path, leaf), (names, _), m in zip(leaves, ref_leaves(arch), moments):
        want = jsh.param_spec(fake, rcfg, [_Key(n) for n in names], leaf)
        got = sh.param_spec(fake, tcfg, path, leaf)
        assert tuple(got) == tuple(want), (names, got, want)
        assert tuple(m.spec) == tuple(jsh.zero_spec(fake, want, tuple(leaf.shape))), names


class _Key:
    """The reference's dict-key path entry."""

    def __init__(self, key):
        self.key = key


def _decode_shapes():
    out = []
    for arch in ARCHES:
        for shape in ("decode_32k", "long_500k"):
            if tsteps.shape_supported(tconfigs.get_config(arch), shape)[0]:
                out.append((arch, shape))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", _decode_shapes())
def test_cache_specs_match_the_reference(arch, shape, mesh):
    fake = FakeMesh(**MESHES[mesh])
    seq_shard = shape == "long_500k"
    rcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    want_tree = jsteps.input_specs(rcfg, shape)["cache"]
    flat, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    got = port_leaves(tsteps.input_specs(tcfg, shape)["cache"])
    assert len(got) == len(flat)
    shardings = [s for _, s in port_leaves(sh.shard_cache(fake, tcfg, tsteps.input_specs(
        tcfg, shape)["cache"], seq_shard=seq_shard))]
    for (path, leaf), (jpath, jleaf), s in zip(got, flat, shardings):
        assert tuple(sh._path_names(path)) == tuple(jsh._path_names(jpath))
        want = jsh.cache_spec(fake, rcfg, jpath, jleaf, seq_shard=seq_shard)
        assert tuple(sh.cache_spec(fake, tcfg, path, leaf, seq_shard=seq_shard)) == tuple(want)
        assert tuple(s.spec) == tuple(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ARCHES)
def test_batch_specs_match_the_reference(arch, shape, mesh):
    fake = FakeMesh(**MESHES[mesh])
    want = jsteps.input_specs(jconfigs.get_config(arch), shape)["batch"]
    got = tsteps.input_specs(tconfigs.get_config(arch), shape)["batch"]
    assert sorted(got) == sorted(want)
    placed = sh.shard_batch(fake, got)
    for k in want:
        spec = tuple(jsh.batch_spec(fake, want[k].shape))
        assert tuple(sh.batch_spec(fake, got[k].shape)) == spec
        assert tuple(placed[k].spec) == spec


# --------------------------------------------------------------------- #
# twins of tests/test_sharding.py
# --------------------------------------------------------------------- #
class TestGuard:
    def test_divisible_kept(self):
        m = FakeMesh(data=4, model=8)
        assert sh.guard(m, P("model", None), (16, 3)) == P("model", None)

    def test_non_divisible_dropped(self):
        m = FakeMesh(data=4, model=8)
        assert sh.guard(m, P("model", None), (12, 3)) == P(None, None)

    def test_composite_falls_back_to_subaxis(self):
        m = FakeMesh(pod=2, data=16)
        assert sh.guard(m, P(("pod", "data"),), (32,)) == P(("pod", "data"))
        assert sh.guard(m, P(("pod", "data"),), (16,)) == P("pod")

    @given(dim=st.integers(1, 4096), axis=st.sampled_from([2, 4, 8, 16]))
    @settings(max_examples=50, deadline=None)
    def test_guard_never_invalid(self, dim, axis):
        m = FakeMesh(model=axis)
        spec = sh.guard(m, P("model"), (dim,))
        if spec[0] is not None:
            assert dim % axis == 0
        assert tuple(spec) == tuple(jsh.guard(m, JP("model"), (dim,)))


def _smoke_specs(arch):
    cfg = tconfigs.get_smoke_config(arch)
    fake = FakeMesh(data=2, model=2)
    return map_with_path(lambda path, leaf: sh.param_spec(fake, cfg, path, leaf),
                         tsteps.abstract_params(cfg))


def test_qwen3_specs():
    specs = _smoke_specs("qwen3-8b")
    assert specs["embed"] == P("model", None)
    unit = specs["groups"][0]
    assert unit["b0"]["mixer"]["wq"][2] == "model"
    assert unit["b0"]["mixer"]["wo"][1] == "model"
    assert unit["b0"]["ffn"]["w_up"][2] == "model"
    assert unit["b0"]["ffn"]["w_down"][1] == "model"
    assert all(a is None for a in unit["b0"]["norm1"]["scale"])


def test_moe_expert_dim_sharded():
    moe = _smoke_specs("phi3.5-moe-42b-a6.6b")["groups"][0]["b0"]["ffn"]
    assert moe["w_up"][1] == "model"     # (L, E, D, F): E sharded
    assert moe["router"] == P(None, None, None)


def test_zero_spec_adds_data_axis():
    fake = FakeMesh(data=4, model=4)
    spec = sh.zero_spec(fake, P(None, "model", None), (8, 4, 64))
    assert "data" in spec
    assert spec[1] == "model"
    assert tuple(spec) == tuple(jsh.zero_spec(fake, JP(None, "model", None), (8, 4, 64)))


def test_decode_cache_seq_on_model():
    cfg = tconfigs.get_config("qwen3-8b")
    fake = FakeMesh(data=16, model=16)
    leaf = torch.empty((36, 128, 32768, 8, 128), device="meta")
    assert sh.cache_spec(fake, cfg, ("k",), leaf) == P(None, "data", "model", None, None)


def test_long_mode_seq_on_both():
    cfg = tconfigs.get_config("zamba2-1.2b")
    fake = FakeMesh(data=16, model=16)

    class K:  # the reference's path entry
        key = "k"

    leaf = torch.empty((6, 1, 4096, 32, 64), device="meta")
    for path in ((K(),), ("k",)):
        spec = sh.cache_spec(fake, cfg, path, leaf, seq_shard=True)
        assert spec[2] == ("data", "model")
        assert spec[1] is None


def test_partition_spec_normalises_as_jax():
    for entries in [("data",), (("data",), None), (("pod", "data"), "model"), ()]:
        assert tuple(P(*entries)) == tuple(JP(*entries))


# --------------------------------------------------------------------- #
# meshes and placement
# --------------------------------------------------------------------- #
def test_meshes_need_a_world_of_their_size():
    with pytest.raises(RuntimeError, match="world of 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="world of 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="world of 4 ranks"):
        tmesh.make_test_mesh(2, 2, device_type="cpu")


def test_the_card_constants():
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.ICI_BW, tmesh.HBM_PER_CHIP) == (
        989e12, 3.35e12, 450e9, 80e9)


class _Mesh2x2:
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


def test_placements():
    m = _Mesh2x2()
    assert sh.axis_sizes(m) == {"data": 2, "model": 2}
    assert sh.NamedSharding(m, P("model", None)).placements == (sh.Replicate(), sh.Shard(0))
    assert sh.NamedSharding(m, P(None, ("data", "model"))).placements == (sh.Shard(1), sh.Shard(1))
    assert sh.NamedSharding(m, P()).placements == (sh.Replicate(), sh.Replicate())
    for bad in (P(("model", "data")), P("pod"), P("data", "data")):
        with pytest.raises(ValueError):
            sh.NamedSharding(m, bad).placements


def place_cases() -> list:
    """``(shape, spec)`` pairs: the specs of Phi-3.5-MoE's and DeepSeek-V3's
    smoke parameters on a (2, 2) mesh with ``ep_axis`` ``"model"`` and
    ``("data", "model")`` and ``fsdp``, the (pod-less) batch and the
    sequence-sharded cache, and composite entries on every dim."""
    fake = FakeMesh(data=2, model=2)
    seen = {}
    for arch in W.EP_ARCHES:
        for ep, fsdp in (("model", False), (("data", "model"), True)):
            cfg = tconfigs.get_smoke_config(arch).with_overrides(ep_axis=ep, fsdp=fsdp)
            for path, leaf in port_leaves(tsteps.abstract_params(cfg)):
                spec = sh.param_spec(fake, cfg, path, leaf)
                if any(e is not None for e in spec):
                    seen.setdefault(tuple(spec), tuple(leaf.shape))
    for shape, spec in [((4, 6), ("data", None)), ((2, 4, 8, 6), (None, None, ("data", "model"), None)),
                        ((8, 3), (("data", "model"), None)), ((2, 4, 6), ("model", "data", None)),
                        ((5, 3), (None, None))]:
        seen.setdefault(spec, shape)
    return [(list(shape), [list(e) if isinstance(e, tuple) else e for e in spec])
            for spec, shape in seen.items()]


@pytest.fixture(scope="module")
def placed(tmp_path_factory):
    out = tmp_path_factory.mktemp("place")
    cases = place_cases()
    ref_file = out / "reference.json"
    (out / "cases.json").write_text(json.dumps(cases))
    ref = W.start_reference("place", ref_file)
    try:
        W.spawn_world(W.place_rank, 4, cases, str(out))
    finally:
        W.finish_reference(ref)
    return cases, json.loads(ref_file.read_text()), [
        dict(np.load(out / f"rank{r}.npz")) for r in range(4)]


def test_place_matches_devices_indices_map(placed):
    cases, ref, ranks = placed
    assert len(cases) >= 10
    for i, (shape, spec) in enumerate(cases):
        full = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
        for rank in range(4):
            box = ref[i][str(rank)]
            want = full[tuple(slice(a, b) for a, b in box)]
            np.testing.assert_array_equal(ranks[rank][str(i)], want, err_msg=f"{spec} rank {rank}")
