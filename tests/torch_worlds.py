"""Helpers of the port's multi-rank CPU tests (pytest does not collect
this module): spawned ``torch.distributed`` gloo worlds, the reference run
in a subprocess on forced host devices, and the cases both sides run.

A world of ``n`` ranks is ``n`` processes started with the ``spawn``
method; each starts its process group over a ``FileStore`` in a temporary
directory (no TCP), with a timeout, runs its target and destroys the
group. The caller joins them within a limit and kills what is left, so a
stuck collective fails its test instead of running into the suite's
limit. The reference runs as ``python tests/torch_worlds.py <what> <out>``
with ``--xla_force_host_platform_device_count=4``: the test process's JAX
has already started on one device.

``tests/test_torch_ep.py`` and ``tests/test_torch_sharding.py`` call
:func:`spawn_world` and :func:`start_reference`; both sides of a case read
the same inputs (:func:`ep_inputs`, made with numpy from a seed; the
placement cases the sharding test writes).
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
#: Seconds a spawned world or the reference subprocess may take in all,
#: and a collective may wait inside one.
JOIN_S = 150
COLLECTIVE_S = 60

# --------------------------------------------------------------------- #
# worlds
# --------------------------------------------------------------------- #
def _run_rank(target, rank, world, store, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    try:
        target(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_world(target, world: int, *args, limit: float = JOIN_S) -> None:
    """``target(rank, world, *args)`` in ``world`` spawned processes, each
    in its gloo process group. Raises if a rank fails or is still running
    after ``limit`` seconds (it is killed)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_run_rank, args=(target, rank, world, store, args))
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + limit
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        stuck = [p for p in procs if p.is_alive()]
        for p in stuck:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
    if stuck or any(codes):
        raise AssertionError(f"world of {world}: exit codes {codes}, "
                             f"{len(stuck)} killed after {limit} s")


def start_reference(what: str, out: Path) -> subprocess.Popen:
    """The reference's side of ``what`` (``"ep"`` or ``"place"``) in a
    subprocess with 4 host devices, writing ``out``."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, str(Path(__file__)), what, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_reference(proc: subprocess.Popen, limit: float = JOIN_S) -> None:
    try:
        log, _ = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"the reference subprocess ran past {limit} s") from None
    if proc.returncode:
        raise AssertionError(f"the reference subprocess failed:\n{log[-4000:]}")


def rank_coords(rank: int, shape) -> tuple[int, ...]:
    """A rank's coordinates on a mesh of ``shape`` (row-major, as
    ``init_device_mesh`` lays the world out)."""
    return tuple(int(c) for c in np.unravel_index(rank, shape))


# --------------------------------------------------------------------- #
# expert parallelism
# --------------------------------------------------------------------- #
EP_ARCHES = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b")   # DeepSeek: shared expert
#: (mesh (data, model), ep_axis)
EP_MESHES = (((1, 2), "model"), ((2, 2), "model"), ((1, 4), "model"),
             ((2, 2), ("data", "model")))
EP_COMBINES = ("psum", "a2a")
#: 8: no copy can be dropped; 1.25 (the default): copies are dropped.
EP_CFS = (8.0, 1.25)
EP_X = (4, 8)
#: A common offset of every token, ``SKEW`` times a normal draw: routing
#: that favours some experts, so that capacity 1.25 drops copies.
SKEW = 2.0
MESH_AXES = ("data", "model")


def ep_cases() -> list[dict]:
    return [dict(arch=a, mesh=m, ep=ep, combine=c, cf=cf)
            for a in EP_ARCHES for m, ep in EP_MESHES for c in EP_COMBINES for cf in EP_CFS]


def case_key(case: dict) -> str:
    ep = case["ep"] if isinstance(case["ep"], str) else "+".join(case["ep"])
    mesh = "x".join(map(str, case["mesh"]))
    return f"{case['arch']}|{mesh}|{ep}|{case['combine']}|{case['cf']}"


def dropless_key(case: dict) -> str:
    return case_key(dict(case, cf=EP_CFS[0]))


def ep_axes(case: dict) -> tuple[str, ...]:
    return (case["ep"],) if isinstance(case["ep"], str) else tuple(case["ep"])


def ep_inputs(cfg, seed: int) -> dict:
    """A MoE layer's parameters (router, expert stacks, the shared expert
    where ``cfg`` has one), the input ``x`` and the output cotangent
    ``ct``, float32 numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    m = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    out = {
        "router": normal((d, e), 0.02),
        "w_gate": normal((e, d, f), d ** -0.5),
        "w_up": normal((e, d, f), d ** -0.5),
        "w_down": normal((e, f, d), f ** -0.5),
    }
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        out["shared/w_gate"] = normal((d, fs), d ** -0.5)
        out["shared/w_up"] = normal((d, fs), d ** -0.5)
        out["shared/w_down"] = normal((fs, d), fs ** -0.5)
    out["x"] = (rng.standard_normal((*EP_X, d)) + SKEW * rng.standard_normal(d)).astype(
        np.float32)
    out["ct"] = normal((*EP_X, d), 1.0)
    return out


def ep_params(arrays: dict, to) -> dict:
    """The parameter tree of :func:`ep_inputs`' arrays, each through ``to``."""
    params = {k: to(v) for k, v in arrays.items() if "/" not in k and k not in ("x", "ct")}
    shared = {k.split("/")[1]: to(v) for k, v in arrays.items() if k.startswith("shared/")}
    if shared:
        params["shared"] = shared
    return params


def ep_rank(rank: int, world: int, cases: list[dict], out: str) -> None:
    """One rank of the port's side: every case of a mesh of ``world``
    ranks. The rank takes its batch block of ``x`` and ``ct`` (by its
    coordinate on the batch axes) and its experts (by its index along the
    ep axes), runs ``moe_apply`` and the gradient of ``sum(y * ct) + aux``
    with respect to every parameter and its ``x`` block, and saves them.
    On the first case with more than one ep rank it also checks that the
    whole expert stacks are refused (local in, local out)."""
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    saved = {}
    meshes = {}
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_test_mesh(*shape, device_type="cpu")
        moe.set_ep_mesh(meshes[shape])
        cfg = get_smoke_config(case["arch"]).with_overrides(
            dtype="float32", ep_axis=case["ep"], ep_capacity_factor=case["cf"],
            ep_combine=case["combine"])
        arrays = ep_inputs(cfg, EP_ARCHES.index(case["arch"]))
        coords = dict(zip(MESH_AXES, rank_coords(rank, shape)))
        sizes = dict(zip(MESH_AXES, shape))
        axes = ep_axes(case)
        ep_index, ep_size = 0, 1
        for a in axes:
            ep_index, ep_size = ep_index * sizes[a] + coords[a], ep_size * sizes[a]
        b_index, b_size = (0, 1) if "data" in axes else (coords["data"], sizes["data"])
        rows = EP_X[0] // b_size
        e_local = cfg.moe.num_experts // ep_size

        def to(v):
            t = torch.from_numpy(v)
            if t.ndim == 3 and t.shape[0] == cfg.moe.num_experts:   # an expert stack
                t = t[ep_index * e_local:(ep_index + 1) * e_local]
            return t.clone().requires_grad_()

        params = ep_params(arrays, to)
        x = torch.from_numpy(arrays["x"][b_index * rows:(b_index + 1) * rows]).requires_grad_()
        ct = torch.from_numpy(arrays["ct"][b_index * rows:(b_index + 1) * rows])
        if ep_size > 1 and "refused" not in saved:
            try:
                moe.moe_apply(cfg, ep_params(arrays, torch.from_numpy), x)
            except ValueError as e:
                saved["refused"] = np.array(str(e))
            else:
                raise AssertionError(f"{case}: the whole expert stacks were not refused")
        y, aux = moe.moe_apply(cfg, params, x)
        leaves = {"router": params["router"], "w_gate": params["w_gate"],
                  "w_up": params["w_up"], "w_down": params["w_down"], "x": x}
        leaves.update({f"shared/{k}": v for k, v in params.get("shared", {}).items()})
        grads = torch.autograd.grad((y * ct).sum() + aux, list(leaves.values()))
        key = case_key(case)
        saved[f"{key}/y"] = y.detach().numpy()
        saved[f"{key}/aux"] = aux.detach().numpy()
        for name, g in zip(leaves, grads):
            saved[f"{key}/g/{name}"] = g.numpy()
        moe.set_ep_mesh(None)
    np.savez(Path(out) / f"rank{rank}.npz", **saved)


def reference_ep(out: str) -> None:
    """The reference's side: each case's ``_moe_local_body`` or
    ``_moe_local_body_a2a`` under its ``_shard_map`` with
    ``moe_forward_ep``'s specs (``moe_forward_ep`` itself fails past a
    1 x 1 mesh under jax 0.9), the shared expert added as it adds it, and
    the gradient of ``sum(y * ct) + mean(aux_vec)`` (every element of
    ``aux_vec`` is the pmean)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_test_mesh
    from repro.models import moe as jm

    saved = {}
    for case in ep_cases():
        cfg = get_smoke_config(case["arch"]).with_overrides(
            dtype="float32", ep_axis=case["ep"], ep_capacity_factor=case["cf"],
            ep_combine=case["combine"])
        arrays = ep_inputs(cfg, EP_ARCHES.index(case["arch"]))
        mesh = make_test_mesh(*case["mesh"])
        axes = ep_axes(case)
        ba = tuple(a for a in ("pod", "data") if a in mesh.shape and a not in axes) or None
        ep_size = int(np.prod([mesh.shape[a] for a in axes]))
        if case["combine"] == "a2a" and EP_X[1] % ep_size == 0:
            bspec, aux_spec, body = P(ba, cfg.ep_axis, None), P(ba, cfg.ep_axis), jm._moe_local_body_a2a
        else:
            bspec, aux_spec, body = P(ba, None, None), P(ba), jm._moe_local_body
        names = tuple(mesh.axis_names)
        wspec = P(cfg.ep_axis, None, None)
        f = jm._shard_map(
            lambda r, wg, wu, wd, xb, body=body, cfg=cfg: body(cfg, names, r, wg, wu, wd, xb),
            mesh=mesh, in_specs=(P(None, None), wspec, wspec, wspec, bspec),
            out_specs=(bspec, aux_spec))
        ct = jnp.asarray(arrays["ct"])

        def loss(p, x, f=f, cfg=cfg, ct=ct):
            y, aux_vec = f(p["router"], p["w_gate"], p["w_up"], p["w_down"], x)
            if "shared" in p:
                y = y + jm.mlp_forward(cfg, p["shared"], x)
            return jnp.sum(y * ct) + jnp.mean(aux_vec), (y, aux_vec)

        params = ep_params(arrays, jnp.asarray)
        (_, (y, aux_vec)), (gp, gx) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(arrays["x"]))
        key = case_key(case)
        saved[f"{key}/y"] = np.asarray(y)
        saved[f"{key}/aux"] = np.asarray(aux_vec).reshape(-1)[0]
        saved[f"{key}/g/x"] = np.asarray(gx)
        for name, g in gp.items():
            if isinstance(g, dict):
                for sub, gg in g.items():
                    saved[f"{key}/g/{name}/{sub}"] = np.asarray(gg)
            else:
                saved[f"{key}/g/{name}"] = np.asarray(g)
    np.savez(out, **saved)


# --------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------- #
PLACE_MESH = (2, 2)


def place_rank(rank: int, world: int, cases: list, out: str) -> None:
    """One rank of the port's side of placement: each ``(shape, spec)`` of
    ``cases`` placed from ``arange`` on the (2, 2) mesh; the rank's local
    blocks saved."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.sharding import P, NamedSharding, place

    mesh = make_test_mesh(*PLACE_MESH, device_type="cpu")
    saved = {}
    for i, (shape, spec) in enumerate(cases):
        full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        saved[str(i)] = place({"t": full}, {"t": NamedSharding(mesh, spec)})["t"].to_local().numpy()
    np.savez(Path(out) / f"rank{rank}.npz", **saved)


def reference_place(out: str) -> None:
    """The reference's side: for each case of ``cases.json`` beside ``out`` the index
    ranges ``NamedSharding(mesh, spec).devices_indices_map(shape)`` gives
    the device at each coordinate of the (2, 2) mesh, as ``[start, stop]``
    per dim, keyed by the coordinate's row-major rank."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.launch.mesh import make_test_mesh

    mesh = make_test_mesh(*PLACE_MESH)
    cases = json.loads((Path(out).parent / "cases.json").read_text())
    result = []
    for shape, spec in cases:
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        index = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
        by_rank = {}
        for coord in np.ndindex(*PLACE_MESH):
            dev = mesh.devices[coord]
            by_rank[int(np.ravel_multi_index(coord, PLACE_MESH))] = [
                [s.start or 0, shape[d] if s.stop is None else s.stop]
                for d, s in enumerate(index[dev])]
        result.append(by_rank)
    Path(out).write_text(json.dumps(result))


# --------------------------------------------------------------------- #
# the dry-run
# --------------------------------------------------------------------- #
#: Small shapes of the dry-run tests, beside ``launch.steps.SHAPES``.
DRY_SHAPES = {
    "t_train": dict(kind="train", seq=32, batch=8),
    "t_prefill": dict(kind="prefill", seq=64, batch=8),
    "t_decode": dict(kind="decode", seq=128, batch=8),
}
#: The reference's ``build_lowered`` and the port's placement on a (2, 2)
#: mesh: Qwen3-8B's smoke config at the three shapes.
ARG_ARCH = "qwen3-8b"
ARG_SHAPES = ("prefill_32k", "decode_32k", "train_4k")


def start_port(what: str, out: Path) -> subprocess.Popen:
    """The port's side of ``what`` in a subprocess (its fake process
    groups die with it), writing ``out``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, str(Path(__file__)), what, str(out)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def plain_step(cfg, shape_name: str, mesh=None, seq=None):
    """The step of ``cfg`` at ``shape_name`` on unplaced ``meta`` inputs:
    the unsharded program, as a thunk."""
    from repro_torch.launch import steps

    info = steps.SHAPES[shape_name]
    params = steps.abstract_params(cfg)
    specs = steps.input_specs(cfg, shape_name, seq=seq)
    if info["kind"] == "train":
        opt = steps.adamw_init_like(cfg, params)
        train = steps.make_train_step(cfg)
        return lambda: train(params, opt, specs["batch"])
    if info["kind"] == "prefill":
        prefill = steps.make_prefill_step(cfg)
        return lambda: prefill(params, specs["batch"])
    decode = steps.make_decode_step(cfg)
    return lambda: decode(params, specs["cache"], specs["token"], (seq or info["seq"]) - 1)


def _counted(step, marks=None) -> dict:
    """The cost vector and collective records of one run of ``step``;
    with ``marks``, the records made inside ``adamw_update`` apart."""
    from repro_torch import roofline as rl

    with rl.CostCounter() as counter:
        if marks is not None:
            marks["counter"] = counter
        step()
    return {"vector": rl._cost_vector(counter), "records": counter.collectives,
            "by_op": counter.by_op}


def _dry_cfg(arch, mesh, **kw):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.moe import set_ep_mesh

    cfg = get_smoke_config(arch).with_overrides(**kw)
    if cfg.moe.num_experts:
        cfg = cfg.with_overrides(ep_axis="model")
        set_ep_mesh(mesh)
    return cfg


def port_dryrun(out: str) -> None:
    """The port's side of ``tests/test_torch_dryrun.py``: counts on fake
    worlds of 1, 2 and 4 ranks, saved as JSON."""
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten

    steps.SHAPES.update(DRY_SHAPES)
    result = {"one": {}, "dp": {}, "tp_bytes": {}, "pinned": {}, "args": {}, "rows": []}

    with dryrun.fake_world(1):
        mesh = make_test_mesh(1, 1, device_type="cpu")
        for arch in ("qwen3-8b", "phi3.5-moe-42b-a6.6b", "whisper-large-v3"):
            cfg = _dry_cfg(arch, mesh)
            for shape in DRY_SHAPES:
                placed = _counted(dryrun.build_step(cfg, shape, mesh))
                plain = _counted(plain_step(cfg, shape))
                result["one"][f"{arch}|{shape}"] = {"placed": placed, "plain": plain}

    with dryrun.fake_world(4):
        mesh = make_test_mesh(4, 1, device_type="cpu")
        quarter = {k: dict(v, batch=v["batch"] // 4) for k, v in DRY_SHAPES.items()}
        for arch in ("qwen3-8b", "phi3.5-moe-42b-a6.6b"):
            cfg = _dry_cfg(arch, mesh)
            for shape in ("t_train", "t_prefill"):
                placed = _counted(dryrun.build_step(cfg, shape, mesh))
                steps.SHAPES[shape] = quarter[shape]
                plain = _counted(plain_step(cfg, shape))
                steps.SHAPES[shape] = DRY_SHAPES[shape]
                result["dp"][f"{arch}|{shape}"] = {"placed": placed["vector"],
                                                   "plain": plain["vector"]}
        mesh = make_test_mesh(1, 4, device_type="cpu")
        for arch in ("qwen3-8b", "deepseek-v3-671b"):
            cfg = _dry_cfg(arch, mesh)
            params_abs = steps.abstract_params(cfg)
            shardings = sh.shard_params(mesh, cfg, params_abs)
            placed = sh.place(params_abs, shardings)
            leaves = [(t.nbytes, s.spec) for t, s in zip(flatten(params_abs)[0],
                                                          flatten(shardings)[0])]
            result["tp_bytes"][arch] = {
                "local": sum(t.to_local().nbytes for t in flatten(placed)[0]),
                "leaves": [[n, [e if not isinstance(e, tuple) else list(e) for e in spec]]
                           for n, spec in leaves]}

        mesh = make_test_mesh(2, 2, device_type="cpu")
        for shape in ARG_SHAPES:
            cfg = _dry_cfg(ARG_ARCH, mesh)
            result["args"][shape] = dryrun.build_step(cfg, shape, mesh).arg_bytes

    with dryrun.fake_world(2):
        for layout in ((2, 1), (1, 2)):
            mesh = make_test_mesh(*layout, device_type="cpu")
            cfg = _dry_cfg("phi3.5-moe-42b-a6.6b", mesh, num_layers=2)
            marks = {}
            update = adamw.adamw_update

            def marked(*args, **kw):
                start = len(marks["counter"].collectives)
                try:
                    return update(*args, **kw)
                finally:
                    marks["span"] = (start, len(marks["counter"].collectives))

            steps.adamw_update = marked
            try:
                counted = _counted(dryrun.build_step(cfg, "t_train", mesh), marks)
            finally:
                steps.adamw_update = update
            a, b = marks["span"]
            params_abs = steps.abstract_params(cfg)
            result["pinned"]["x".join(map(str, layout))] = {
                "update": counted["records"][a:b],
                "step": counted["records"][:a],
                "leaves": [[list(t.shape), str(t.dtype).split(".")[-1],
                            [list(e) if isinstance(e, tuple) else e for e in
                             sh.zero_spec(mesh, sh.param_spec(mesh, cfg, p, t), tuple(t.shape))],
                            "/".join(map(str, p))]
                           for p, t in zip(_paths(params_abs), flatten(params_abs)[0])],
            }
    result["rows"] = [dryrun.run_one("qwen3-8b", "decode_32k", False, verbose=False),
                      dryrun.run_one("whisper-large-v3", "long_500k", False, verbose=False)]
    Path(out).write_text(json.dumps(result))


def _paths(tree):
    """The key paths of a tree's leaves, in :func:`repro_torch.tree.flatten`'s order."""
    from repro_torch.tree import flatten, map_with_path

    paths = []
    map_with_path(lambda path, leaf: paths.append(tuple(path)), tree)
    assert len(paths) == len(flatten(tree)[0])
    return paths


def reference_dryrun(out: str) -> None:
    """The reference's side: ``build_lowered`` of Qwen3-8B's smoke config
    on a (2, 2) mesh of the first four of the dry-run's forced host
    devices, and each compiled program's per-device argument bytes and
    cost analysis."""
    import jax

    from repro.configs import get_smoke_config
    from repro.launch import dryrun

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    result = {}
    for shape in ARG_SHAPES:
        compiled = dryrun.build_lowered(get_smoke_config(ARG_ARCH), shape, mesh).compile()
        cost = compiled.cost_analysis()
        cost = cost[0] if isinstance(cost, list) else cost
        result[shape] = {"args": compiled.memory_analysis().argument_size_in_bytes,
                         "flops": float(cost.get("flops", 0.0)),
                         "bytes": float(cost.get("bytes accessed", 0.0))}
    Path(out).write_text(json.dumps(result))


if __name__ == "__main__":
    {"ep": reference_ep, "place": reference_place, "dryrun": port_dryrun,
     "dryrun_ref": reference_dryrun}[sys.argv[1]](sys.argv[2])
