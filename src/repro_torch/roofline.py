"""Roofline terms of a step on a mesh, from a counted run.

Counterpart of the reference's ``repro.roofline``. Per (arch × shape ×
mesh), from one rank's counted run of the step:

    compute    = FLOPs            / peak FLOP/s      [per device]
    memory     = bytes            / HBM rate         [per device]
    collective = collective bytes / NVLink rate      [per device]

The reference reads XLA's cost analysis of the partitioned module. The
port has no compiler to ask: :class:`CostCounter` counts what one rank
runs. It is a ``TorchDispatchMode`` that lets DTensor's dispatch go first
and sees, beneath it, the rank's operations on its *local* tensors, with
the local shapes the partitioned module holds, and the collectives that
DTensor's redistributions and the MoE layer's c10d calls issue. So every
term is already per device. The run is on ``meta`` tensors
(``repro_torch.launch.dryrun``): shapes only, nothing computed.

* **FLOPs**: ``torch.utils.flop_counter``'s formulas, plus
  :func:`grouped_mm_flops` (the MoE experts) and :func:`addmm_flops`
  (``addmm_``, the unembedding's backward), which it lacks.
* **bytes**: the operand and output bytes of every operation that is not
  a view or a metadata operation (a fill writes only): XLA's "bytes
  accessed" of a program that fuses nothing, which eager PyTorch is.
* **collectives**: each one's kind and result bytes; :func:`collective_bytes`
  scales them by the reference's wire factors (a ring all-reduce moves
  about twice its payload, the others once).
* **temp bytes**: the peak of the live intermediate outputs (each
  registered when an operation makes it, released through
  ``weakref.finalize``), the counterpart of ``memory_analysis()``'s
  temporaries.

The reference's ``_shape_bytes`` and its HLO regexes parse compiled text,
which the port does not have; the collectives arrive here as records.
The peaks are one NVIDIA H100 80GB HBM3's (700 W) spec-sheet rates
(:mod:`repro_torch.launch.mesh`), not measurements.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from fractions import Fraction

import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry, shape_wrapper

from .launch import mesh as mesh_mod

_COLLECTIVES = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# Ring all-reduce = reduce-scatter + all-gather ≈ 2x payload on the wire.
_WIRE_FACTOR = {"all-reduce": 2.0}

#: Operator names (without overload) of the functional collectives and of
#: c10d's, by kind.
_KIND_OF = {
    **dict.fromkeys(("all_reduce", "all_reduce_", "all_reduce_coalesced",
                     "all_reduce_coalesced_", "allreduce_", "allreduce_coalesced_"),
                    "all-reduce"),
    **dict.fromkeys(("all_gather_into_tensor", "all_gather_into_tensor_out",
                     "all_gather_into_tensor_coalesced", "allgather_", "_allgather_base_",
                     "allgather_coalesced_", "allgather_into_tensor_coalesced_", "broadcast_"),
                    "all-gather"),
    **dict.fromkeys(("reduce_scatter_tensor", "reduce_scatter_tensor_coalesced",
                     "reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_"), "reduce-scatter"),
    **dict.fromkeys(("all_to_all_single", "alltoall_", "alltoall_base_",
                     "shard_dim_alltoall"), "all-to-all"),
    "recv_": "collective-permute",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d", "_dtensor")
#: aten operations that write their output without reading their tensor
#: operands (a fill, or a tensor made like another).
_WRITE_ONLY = frozenset((
    "new_zeros", "new_ones", "new_full", "zeros_like", "ones_like", "full_like", "fill_",
    "zero_",
))
#: aten operations that move no data: allocation without a fill, aliasing,
#: metadata.
_FREE = frozenset((
    "empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
    "_unsafe_view", "lift_fresh", "detach", "alias", "set_", "resize_",
    "_local_scalar_dense", "is_same_size", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset",
))


def grouped_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``torch._grouped_mm``: every row of a 2-D ``a`` meets one group of
    ``b`` (3-D: ``(groups, K, N)``), or a 2-D by 2-D product split along
    its contraction (the weight gradient)."""
    n = b_shape[-1]
    return 2 * a_shape[0] * a_shape[1] * n


def addmm_flops(self_shape, a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``addmm_``: the product's multiply-adds (the addition is left out,
    as ``torch.utils.flop_counter``'s ``addmm`` leaves it out)."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


#: The formulas :class:`CostCounter` adds to ``torch.utils.flop_counter``'s,
#: in ``FlopCounterMode(custom_mapping=...)``'s form.
FLOP_FORMULAS = {
    torch.ops.aten._grouped_mm: grouped_mm_flops,
    torch.ops.aten.addmm_: addmm_flops,
}


def collective_bytes(records) -> dict[str, float]:
    """Wire bytes per device, by collective kind, from ``(kind, result
    bytes)`` records (:attr:`CostCounter.collectives`)."""
    out: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for kind, nbytes in records:
        out[kind] += nbytes * _WIRE_FACTOR.get(kind, 1.0)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_size(args) -> int:
    """The size of the process group a collective's arguments name (a
    ProcessGroup, or a functional collective's group name): a group of
    one moves nothing."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in args:
        if isinstance(a, ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name().endswith(
                "c10d.ProcessGroup"):
            return ProcessGroup.unbox(a).size()
    for a in reversed(args):
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
    return 2


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and peak temporaries of what
    one rank runs, beneath DTensor (see the module's docstring). An
    operation on DTensors is handed back to DTensor (``NotImplemented``),
    which runs the local operations this mode then counts; DTensor's own
    propagation of global shapes, which runs under a ``FakeTensorMode``,
    is not counted."""

    def __init__(self):
        super().__init__()
        formulas = {**flop_registry,
                    **{op: shape_wrapper(f) for op, f in FLOP_FORMULAS.items()}}
        self._formulas = formulas
        self.flops = 0
        self.bytes = 0
        self.collectives: list[tuple[str, int]] = []
        #: ``{operator name: [flops, bytes]}``: where the counts come from.
        self.by_op: dict[str, list[int]] = {}
        self.live = 0
        self.peak = 0

    def _release(self, nbytes: int) -> None:
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or isinstance(
                _get_current_dispatch_mode(), FakeTensorMode):
            return out
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NAMESPACES:
            kind = _KIND_OF.get(name)
            if kind is not None and _group_size(args) > 1:
                # c10d's operations write their result into their first
                # argument; the functional ones return it.
                result = args[0] if ns == "c10d" else out
                self.collectives.append((kind, sum(map(_nbytes, _tensors(result)))))
            return out
        if ns != "aten" or func.is_view or name in _FREE:
            return out
        inputs = _tensors((args, kwargs))
        outputs = _tensors(out)
        if name == "_to_copy" and inputs[0].device != outputs[0].device:
            return out      # a transfer from the host, kept on the device after it
        formula = self._formulas.get(func._overloadpacket)
        flops = 0 if formula is None else int(formula(*args, **kwargs, out_val=out))
        nbytes = sum(map(_nbytes, outputs))
        if name not in _WRITE_ONLY:
            nbytes += sum(map(_nbytes, inputs))
        self.flops += flops
        self.bytes += nbytes
        entry = self.by_op.setdefault(name, [0, 0])
        entry[0] += flops
        entry[1] += nbytes
        for t in outputs:
            if any(t is a for a in inputs):
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._release, n)
        return out


def _cost_vector(counter: CostCounter) -> dict:
    """A counted run as a vector: ``flops``, ``bytes``, ``temp`` (the peak
    temporaries) and ``coll:<kind>`` wire bytes."""
    coll = collective_bytes(counter.collectives)
    return {
        "flops": counter.flops,
        "bytes": counter.bytes,
        "temp": counter.peak,
        **{f"coll:{k}": v for k, v in coll.items()},
    }


def count(step) -> dict:
    """:func:`_cost_vector` of one call of ``step`` (a thunk) under a
    :class:`CostCounter`."""
    with CostCounter() as counter:
        step()
    return _cost_vector(counter)


def _vec_sub(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}


def _vec_axpy(acc: dict, alpha, d: dict) -> dict:
    return {k: acc.get(k, 0) + alpha * d.get(k, 0) for k in set(acc) | set(d)}


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh_desc: str
    chips: int
    flops: float                   # per chip
    hbm_bytes: float               # per chip
    coll_bytes: float              # per chip (wire)
    coll_breakdown: dict = field(default_factory=dict)
    model_flops: float = 0.0       # 6*N*D (global, active params)
    peak_flops: float = mesh_mod.PEAK_FLOPS_BF16
    hbm_bw: float = mesh_mod.HBM_BW
    ici_bw: float = mesh_mod.ICI_BW

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.ici_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted flops): remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh_desc,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops_per_chip": self.flops,
            "useful_ratio": self.useful_flops_ratio,
        }


def mesh_desc(mesh) -> str:
    """``data=16xmodel=16``: the reference's mesh description."""
    from .models.sharding import axis_sizes

    return "x".join(f"{k}={v}" for k, v in axis_sizes(mesh).items())


def analyse(*, arch: str, shape: str, mesh, vector: dict, model_flops: float = 0.0
            ) -> RooflineReport:
    """The report of a cost vector (:func:`count`, :func:`measure_corrected`)
    of ``arch`` at ``shape`` on ``mesh``."""
    from .models.sharding import axis_sizes

    coll = {k.split(":", 1)[1]: float(v) for k, v in vector.items() if k.startswith("coll:")}
    chips = 1
    for v in axis_sizes(mesh).values():
        chips *= v
    return RooflineReport(
        arch=arch,
        shape=shape,
        mesh_desc=mesh_desc(mesh),
        chips=chips,
        flops=float(vector["flops"]),
        hbm_bytes=float(vector["bytes"]),
        coll_bytes=sum(coll.values()),
        coll_breakdown=coll,
        model_flops=model_flops,
    )


# --------------------------------------------------------------------- #
# Depth- and length-corrected counts.
#
# Eager PyTorch runs every layer and every step of a loop, so a count is
# never short of work the way XLA's cost analysis of a scan is. What it
# costs is time: on ``meta`` tensors under DTensor a full-depth count runs
# every operation of every layer through Python, and a recurrence's
# 4096- or 32,768-step loop takes minutes. Counts are additive, so the
# reference's probe algebra recovers the full count from small probes:
# every scan group at one unit (A0), then group i at two (Ai), and
#
#     total = A0 + Σ_i (true_count_i − 1) · (Ai − A0).
#
# The step-loop kinds (Mamba2, mLSTM, sLSTM) are also probed over the
# sequence length: three lengths that are multiples of the mLSTM chunk,
# and the polynomial of degree 2 through them evaluated at the shape's
# length. Their loops are linear in the length and Zamba2's shared
# attention quadratic, so the fit is exact.
# --------------------------------------------------------------------- #
#: Layer kinds whose sequence forms loop over time.
STEP_LOOP_KINDS = ("mamba2", "mlstm", "slstm")
#: The sequence probes' unit: the mLSTM chunk.
SEQ_UNIT = 64


def _local_len(mesh, entry, n: int) -> int:
    """``n`` divided by the size of the mesh axes of one spec entry."""
    from .models.sharding import _axis_size

    return n // _axis_size(mesh, entry) if entry is not None else n


def seq_probes(cfg, shape_name: str, mesh) -> list[int] | None:
    """The three sequence lengths a step-loop model's ``shape_name`` is
    probed at, or None (no loop over time, or a shape too short to probe).

    The lengths are the smallest multiples of :data:`SEQ_UNIT` at which
    the training step's embedding backward's worst-case row count ``min(tokens,
    vocabulary rows)`` (``models.common._Embed``), on this rank's tokens
    and vocabulary block, takes the branch it takes at the full length:
    there it is a fixed count, or linear in the length, and the fit stays
    exact; and at least two units: at one chunk DTensor lays the step out
    otherwise (it gathers more), and the counts leave the polynomial."""
    from .launch.steps import SHAPES
    from .models import sharding as sh
    from .models.model import layer_kinds

    info = SHAPES[shape_name]
    if info["kind"] == "decode" or not set(layer_kinds(cfg)) & set(STEP_LOOP_KINDS):
        return None
    b, s = info["batch"], info["seq"]
    rows = _local_len(mesh, sh.batch_spec(mesh, (b, s))[0], b)
    embed = torch.empty((cfg.vocab_size, cfg.d_model), device="meta")
    vocab = _local_len(mesh, sh.param_spec(mesh, cfg, ("embed",), embed)[0], cfg.vocab_size)
    k0 = 2
    if info["kind"] == "train" and rows * s >= vocab:
        k0 = max(k0, -(-vocab // (rows * SEQ_UNIT)))
    lengths = [SEQ_UNIT * (k0 + j) for j in range(3)]
    return lengths if lengths[-1] < s else None


def _fit(xs: list[int], ys: list[dict], x: int) -> dict:
    """Each key's polynomial of degree ``len(xs) - 1`` through ``(xs,
    ys)`` at ``x``, exactly (Lagrange, in fractions)."""
    out = {}
    for key in set().union(*ys):
        total = Fraction(0)
        for j, (xj, yj) in enumerate(zip(xs, ys)):
            w = Fraction(1)
            for m, xm in enumerate(xs):
                if m != j:
                    w *= Fraction(x - xm, xj - xm)
            total += w * Fraction(yj.get(key, 0))
        out[key] = total
    return out


def _exact(v):
    v = Fraction(v)
    return int(v) if v.denominator == 1 else float(v)


def measure_corrected(cfg, shape_name: str, mesh, build_step) -> dict:
    """The full count of ``cfg`` at ``shape_name`` on ``mesh`` from probe
    counts (see above): a cost vector (``flops``, ``bytes``, ``temp``,
    ``coll:<kind>``).

    ``build_step(cfg, shape_name, mesh, seq=None)`` must return a thunk
    that runs the step once on the placed inputs (``seq`` replaces the
    shape's sequence length); the step must run inside the caller's
    process group, if it needs one. ``temp`` goes through the same algebra:
    exact where the peak grows by a fixed amount per layer (training's
    saved activations) or not at all (inference), an estimate otherwise.
    """
    from .launch.steps import SHAPES
    from .models.model import _scan_groups_raw

    groups = _scan_groups_raw(cfg)
    dims = [c for _, c in groups]
    has_enc = cfg.encoder_layers > 0
    if has_enc:
        dims.append(cfg.encoder_layers)
    lengths = seq_probes(cfg, shape_name, mesh)

    def probe_cfg(counts):
        kw = {"scan_counts_override": tuple(counts[: len(groups)])}
        if has_enc:
            kw["encoder_layers"] = counts[len(groups)]
        return cfg.with_overrides(**kw)

    def probe(counts):
        pcfg = probe_cfg(counts)
        if lengths is None:
            return {k: Fraction(v) for k, v in count(build_step(pcfg, shape_name, mesh)).items()}
        ys = [count(build_step(pcfg, shape_name, mesh, seq=n)) for n in lengths]
        return _fit(lengths, ys, SHAPES[shape_name]["seq"])

    base = [1] * len(dims)
    # One uncounted run first: what the program makes once per process
    # (the recurrences' cached constants) is then in no probe's count.
    build_step(probe_cfg(base), shape_name, mesh, seq=lengths[0] if lengths else None)()
    vec0 = probe(base)
    total = dict(vec0)
    for i, true_count in enumerate(dims):
        if true_count <= 1:
            continue
        counts = list(base)
        counts[i] = 2
        unit = _vec_sub(probe(counts), vec0)
        total = _vec_axpy(total, true_count - 1, unit)
    return {k: _exact(v) for k, v in total.items()}


def model_flops_for(cfg, shape_name: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference forward), with
    N = active params (MoE) and D = tokens processed."""
    n = cfg.active_param_count()
    if shape_name.startswith("train"):
        return 6.0 * n * batch * seq
    if shape_name.startswith("prefill"):
        return 2.0 * n * batch * seq
    return 2.0 * n * batch  # decode: one token per sequence
