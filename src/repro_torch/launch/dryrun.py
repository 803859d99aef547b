"""Dry-run: count every (arch × shape) step on the production meshes and
derive its roofline terms, on no device.

Counterpart of the reference's ``repro.launch.dryrun``, which lowers and
compiles each step for 512 forced host devices and reads XLA's memory
and cost analysis. The port runs each step once on ``meta`` tensors
(shapes only, nothing computed) placed as DTensors on the (data=16,
model=16) or (pod=2, data=16, model=16) mesh of a *fake* process group
of 256 (512) ranks, and counts what rank 0 runs beneath DTensor
(:class:`repro_torch.roofline.CostCounter`). The fake world starts inside
:func:`run_one` and ends with it; importing this module starts nothing.
Without the fake backend or its store it raises: there is no smaller
mesh to fall back to.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.jsonl]

A row carries the reference's keys, with ``count_s`` (the seconds of the
probe counts, :func:`repro_torch.roofline.measure_corrected`) in place of
``lower_s`` and no ``compile_s``: nothing is compiled.

Where DTensor's own rule would move far more than the reference's
partitioned program, the step runs another form with the same local work:

* the embedding and the unembedding run vocabulary-parallel
  (``models.common``), and ``softmax`` / ``log_softmax`` over a sharded
  dim (the logits' vocabulary, a decode's cache positions) run on each
  rank's block with the row maxima and sums all-reduced
  (:func:`sharded_softmax`), where DTensor would gather the input;
* a decode writes its cache row on the rank that holds it
  (``models.attention._write_row``), where DTensor would gather the cache;
* each norm sums its input's partial sums, forward and backward
  (``models.common._SumPartials``), and attention runs per block of query
  heads (``models.attention._sdpa_heads``), where DTensor would gather
  the next product's weights or every head;
* the update reduces each gradient once into its moment's (ZeRO) layout
  (``optim.adamw``), where each of its operations would reduce it again;
* the MoE layer's expert-parallel body runs on each rank's blocks through
  ``local_map`` (``models.moe._ep_routed_sharded``);
* a redistribution from one sharded dim to another is one all-to-all, as
  on the card's mesh (:func:`card_all_to_all`), where DTensor on a CPU
  mesh gathers the whole tensor.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import all_arch_ids, get_config
from ..models import sharding as sh
from ..models.config import ModelConfig
from ..models.moe import set_ep_mesh
from ..roofline import analyse, measure_corrected, model_flops_for
from ..tree import flatten
from .mesh import PRODUCTION_SHAPE, make_production_mesh
from .steps import (
    SHAPES,
    abstract_params,
    adamw_init_like,
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    shape_supported,
)

aten = torch.ops.aten


# --------------------------------------------------------------------- #
# the fake world
# --------------------------------------------------------------------- #
@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process is rank 0):
    collectives return at once and move nothing. Destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry-run starts its own fake world; a process group is running")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        set_ep_mesh(None)
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# counting forms
# --------------------------------------------------------------------- #
def _below_autograd(handler):
    """A DTensor operator handler runs beneath autograd, which has already
    recorded the operation: the DTensor calls it makes inside (the
    redistributions, ``to_local``, ``from_local``) record nothing."""

    def run(op, args, kwargs):
        with torch.no_grad():
            return handler(op, args, kwargs)

    return run


def _rewrap(local: torch.Tensor, like: DTensor) -> DTensor:
    return DTensor.from_local(local, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def _split(x: DTensor, dim: int):
    """``x`` with Partial placements reduced, its local block, and the
    mesh dim that shards ``dim`` (or None)."""
    placements = [Replicate() if p.is_partial() else p for p in x.placements]
    x = _moved(x, placements)
    vocab = [i for i, p in enumerate(placements) if p.is_shard(dim)]
    return x, x.to_local(), (x.device_mesh, vocab[0]) if vocab else None


def _moved(x: DTensor, placements) -> DTensor:
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


@_below_autograd
def _log_softmax(op, args, kwargs):
    x, dim, half_to_float = args
    dim %= x.ndim
    x, local, group = _split(x, dim)
    if group is None:
        return _rewrap(op(local, dim, half_to_float), x)
    if half_to_float:
        local = local.to(torch.float32)
    lse = torch.logsumexp(local, dim, keepdim=True)
    top = _all_reduce(lse, "max", group)
    total = _all_reduce(torch.exp(lse - top), "sum", group)
    return _rewrap(local - (top + torch.log(total)), x)


@_below_autograd
def _log_softmax_backward(op, args, kwargs):
    grad, out, dim, input_dtype = args
    dim %= out.ndim
    out, o, group = _split(out, dim)
    g = _moved(grad, out.placements).to_local()
    if group is None:
        return _rewrap(op(g, o, dim, input_dtype), out)
    total = _all_reduce(g.sum(dim, keepdim=True), "sum", group)
    return _rewrap((g - torch.exp(o) * total).to(input_dtype), out)


@_below_autograd
def _softmax(op, args, kwargs):
    x, dim, half_to_float = args
    dim %= x.ndim
    x, local, group = _split(x, dim)
    if group is None:
        return _rewrap(op(local, dim, half_to_float), x)
    if half_to_float:
        local = local.to(torch.float32)
    top = _all_reduce(torch.amax(local, dim, keepdim=True), "max", group)
    e = torch.exp(local - top)
    return _rewrap(e / _all_reduce(e.sum(dim, keepdim=True), "sum", group), x)


@_below_autograd
def _softmax_backward(op, args, kwargs):
    grad, out, dim, input_dtype = args
    dim %= out.ndim
    out, o, group = _split(out, dim)
    g = _moved(grad, out.placements).to_local()
    if group is None:
        return _rewrap(op(g, o, dim, input_dtype), out)
    total = _all_reduce((g * o).sum(dim, keepdim=True), "sum", group)
    return _rewrap((o * (g - total)).to(input_dtype), out)


@_below_autograd
def _argmax(op, args, kwargs):
    x, dim, keepdim = (list(args) + [None, False])[:3]
    if dim is None:
        raise ValueError("the dry-run's argmax takes a dim")
    dim %= x.ndim
    placements = [Replicate() if p.is_partial() or p.is_shard(dim) else p
                  for p in x.placements]
    x = _moved(x, placements)
    out = op(x.to_local(), dim, keepdim)
    if not keepdim:
        placements = [p.__class__(p.dim - 1) if p.is_shard() and p.dim > dim else p
                      for p in placements]
    shape = list(x.shape)
    if keepdim:
        shape[dim] = 1
    else:
        del shape[dim]
    return DTensor.from_local(out, x.device_mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=out.stride())


@_below_autograd
def _unbind(op, args, kwargs):
    x, dim = (list(args) + [0])[:2]
    dim %= x.ndim
    placements = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    x = _moved(x, placements)
    moved = [p.__class__(p.dim - 1) if p.is_shard() and p.dim > dim else p for p in placements]
    shape = [n for i, n in enumerate(x.shape) if i != dim]
    return tuple(DTensor.from_local(t, x.device_mesh, moved, run_check=False,
                                    shape=torch.Size(shape), stride=t.stride())
                 for t in op(x.to_local(), dim))


@contextlib.contextmanager
def sharded_softmax():
    """``softmax`` and ``log_softmax`` (and their backwards) over a dim
    that a mesh dim shards, each rank on its own block, the row maxima
    and sums all-reduced over that mesh dim: the logits sharded by
    vocabulary, a decode's scores sharded by cache position. DTensor's
    rule gathers the whole input first. Over an unsharded dim the
    operation runs on the local block, Partial placements reduced first.
    ``argmax`` over a sharded dim gathers its input along that dim
    (DTensor's own rule for it fails on ``meta`` tensors), and so does
    ``unbind`` (a recurrence's steps, which DTensor refuses)."""
    handlers = DTensor._op_dispatcher._custom_op_handlers
    saved = dict(handlers)
    handlers.update({
        aten._log_softmax.default: _log_softmax,
        aten._log_softmax_backward_data.default: _log_softmax_backward,
        aten._softmax.default: _softmax,
        aten._softmax_backward_data.default: _softmax_backward,
        aten.argmax.default: _argmax,
        aten.unbind.int: _unbind,
    })
    try:
        yield
    finally:
        handlers.clear()
        handlers.update(saved)


@contextlib.contextmanager
def card_all_to_all():
    """A redistribution from one sharded dim to another as the card's mesh
    moves it, one all-to-all (``_dtensor::shard_dim_alltoall``); DTensor on
    a CPU mesh gathers the whole tensor and chunks it (gloo has no
    all-to-all)."""
    from torch.distributed.tensor import placement_types as pt

    def on_card(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))

    saved = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = on_card
    try:
        yield
    finally:
        pt.shard_dim_alltoall = saved


# --------------------------------------------------------------------- #
# steps
# --------------------------------------------------------------------- #
def _local_bytes(tree) -> int:
    total = 0
    for t in flatten(tree)[0]:
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return total


@dataclass
class Step:
    """A placed step: ``run()`` runs it once; ``args`` are its placed
    inputs and ``out_bytes`` its outputs' bytes on one rank."""

    run: Callable[[], object]
    args: tuple
    out_bytes: int

    def __call__(self):
        return self.run()

    @property
    def arg_bytes(self) -> int:
        return _local_bytes(list(self.args))


def _out_bytes(mesh, shape: tuple[int, ...], dtype: torch.dtype, spec) -> int:
    sizes = sh.axis_sizes(mesh)
    n = 1
    for d, entry in zip(shape, list(spec) + [None] * len(shape)):
        names = () if entry is None else entry if isinstance(entry, tuple) else (entry,)
        n *= d // math.prod(sizes[a] for a in names)
    return n * torch.empty((), dtype=dtype).element_size()


def build_step(cfg: ModelConfig, shape_name: str, mesh, seq: int | None = None,
               remat: bool = True) -> Step:
    """The counterpart of the reference's ``build_lowered``: the step for
    (cfg, shape) on ``mesh``, its ``meta`` inputs placed by
    ``models.sharding``'s specs, as a :class:`Step`. ``seq`` replaces the
    shape's sequence length (the probes of
    :func:`repro_torch.roofline.measure_corrected`); ``remat`` is the
    training step's (the reference's default, on)."""
    info = SHAPES[shape_name]
    params_abs = abstract_params(cfg)
    params = sh.place(params_abs, sh.shard_params(mesh, cfg, params_abs))
    specs = input_specs(cfg, shape_name, seq=seq)
    ba = sh.batch_axes(mesh)

    def counted(fn):
        def run():
            with implicit_replication(), sharded_softmax(), card_all_to_all():
                return fn()
        return run

    if info["kind"] == "train":
        opt_abs = adamw_init_like(cfg, params_abs)
        opt = sh.place(opt_abs, sh.shard_opt_state(mesh, cfg, params_abs, opt_abs))
        batch = sh.place(specs["batch"], sh.shard_batch(mesh, specs["batch"]))
        step = make_train_step(cfg, remat=remat)
        metrics = 4 if cfg.mtp else 3
        out = _local_bytes([params, opt]) + 4 * metrics
        return Step(counted(lambda: step(params, opt, batch)), (params, opt, batch), out)

    if info["kind"] == "prefill":
        batch = sh.place(specs["batch"], sh.shard_batch(mesh, specs["batch"]))
        step = make_prefill_step(cfg)
        out_spec = sh.guard(mesh, sh.P(ba, "model"), (info["batch"], cfg.vocab_size))
        out_pl = sh.NamedSharding(mesh, out_spec).placements

        def prefill():
            logits = step(params, batch)
            return logits.redistribute(mesh, out_pl) if isinstance(logits, DTensor) else logits

        out = _out_bytes(mesh, (info["batch"], cfg.vocab_size), torch.float32, out_spec)
        return Step(counted(prefill), (params, batch), out)

    long_mode = bool(info.get("long"))
    cache = sh.place(specs["cache"], sh.shard_cache(mesh, cfg, specs["cache"],
                                                    seq_shard=long_mode))
    token_spec = sh.guard(mesh, sh.P(ba), (info["batch"], 1))
    token_sh = sh.NamedSharding(mesh, token_spec)
    token = sh.place(specs["token"], token_sh)
    pos = specs["pos"]
    step = make_decode_step(cfg, long_mode=long_mode)

    def decode():
        nxt, _ = step(params, cache, token, (seq or info["seq"]) - 1)
        return nxt.redistribute(mesh, token_sh.placements) if isinstance(nxt, DTensor) else nxt

    out = _out_bytes(mesh, (info["batch"], 1), torch.int32, token_spec) + _local_bytes(cache)
    return Step(counted(decode), (params, cache, token, pos), out)


# --------------------------------------------------------------------- #
# one pair
# --------------------------------------------------------------------- #
def _ep_config(cfg: ModelConfig, shape_name: str, multi_pod: bool) -> ModelConfig:
    """The reference's expert-parallel axes: at decode with E ≥ 64 the
    widest combination of axes that divides the expert count (each device
    reads only its own experts; multi-pod: 512 devices > 256 experts, so
    EP within each pod), ``model`` otherwise."""
    info = SHAPES[shape_name]
    if info["kind"] == "decode" and cfg.moe.num_experts >= 64:
        sizes = {"pod": 2, "data": 16, "model": 16}
        axes = ("model",)
        for extra in ("data", "pod") if multi_pod else ("data",):
            cand = (extra, *axes)
            if cfg.moe.num_experts % math.prod(sizes[a] for a in cand) == 0:
                axes = cand
        return cfg.with_overrides(ep_axis=axes)
    return cfg.with_overrides(ep_axis="model")


def run_one(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    verbose: bool = True,
    overrides: dict | None = None,
):
    cfg = get_config(arch)
    if cfg.moe.num_experts:
        cfg = _ep_config(cfg, shape_name, multi_pod)
    if overrides:
        cfg = cfg.with_overrides(**overrides)
    ok, reason = shape_supported(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped", "reason": reason}
    info = SHAPES[shape_name]
    with fake_world(math.prod(PRODUCTION_SHAPE[multi_pod])):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        if cfg.moe.num_experts:
            set_ep_mesh(mesh)
        t0 = time.time()
        corr = measure_corrected(cfg, shape_name, mesh, build_step)
        t_count = time.time() - t0
        full = build_step(cfg, shape_name, mesh)
        arg_bytes, out_bytes = full.arg_bytes, full.out_bytes
    report = analyse(arch=arch, shape=shape_name, mesh=mesh, vector=corr,
                     model_flops=model_flops_for(cfg, shape_name, info["batch"], info["seq"]))
    row = report.row()
    row.update(
        status="ok",
        count_s=round(t_count, 1),
        bytes_per_device=arg_bytes + out_bytes,
        arg_bytes=arg_bytes,
        temp_bytes=corr["temp"],
        coll_breakdown={k: v for k, v in report.coll_breakdown.items() if v},
    )
    if verbose:
        print(f"--- {arch} x {shape_name} on {row['mesh']} ---")
        print(f"bytes per device: arguments {arg_bytes}, outputs {out_bytes}, "
              f"peak temporaries {corr['temp']}")
        print("counts: flops=%.3e bytes=%.3e" % (report.flops, report.hbm_bytes))
        print(
            "roofline: compute=%.2es memory=%.2es collective=%.2es -> %s"
            % (report.t_compute, report.t_memory, report.t_collective, report.bottleneck)
        )
        print(f"useful-flops ratio: {report.useful_flops_ratio:.3f}")
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None, help="append result rows to file")
    ap.add_argument(
        "--moe-combine", default=None, choices=("psum", "a2a"),
        help="MoE expert-parallel combine strategy override",
    )
    ap.add_argument("--fsdp", action="store_true", help="FSDP weight sharding")
    args = ap.parse_args(argv)
    overrides = {}
    if args.moe_combine:
        overrides["ep_combine"] = args.moe_combine
    if args.fsdp:
        overrides["fsdp"] = True

    if args.all:
        pairs = [(a, s) for a in all_arch_ids() for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]

    rows, failures = [], 0
    for arch, shape_name in pairs:
        try:
            row = run_one(arch, shape_name, args.multi_pod, overrides=overrides)
        except Exception as e:  # noqa: BLE001 — report and continue
            traceback.print_exc()
            row = {
                "arch": arch,
                "shape": shape_name,
                "status": "FAILED",
                "error": f"{type(e).__name__}: {e}",
            }
            failures += 1
        rows.append(row)
        print(json.dumps(row, default=str))
        sys.stdout.flush()
    if args.json:
        with open(args.json, "a") as f:
            for r in rows:
                f.write(json.dumps(r, default=str) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
