"""One run of one cell: set-up, warm-up, the measured window, the check.

The system under test is the port's trainer,
``repro_torch.gnn.train.DistributedTrainer(device="cuda").run()``, built
once in set-up from the benchmark's own graph arrays and initial weights
and driven by whole ``run()`` calls of ``epochs_per_call`` epochs. The
first call is the warm-up; it runs with the harness's captures (the
program's per-step streams through its trace hook, the raw frontier
blocks, the parameters after the first steps). The window then starts
calls on the same trainer, which trains on, until ``seconds`` have
passed; its first call keeps the same streams and the losses of its
first steps. Once the window has closed, the reference follows the
whole warm-up call and the first steps of the window's first call, so
that what one call hands the next (the buffer, the fanout generator,
the parameters) is checked too.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import check, generate
from .cells import Cell, metric_reader, reference
from .profile import WINDOW, Profile, analyse, read_events

#: Steps of the training check: the reference follows the first three
#: of the warm-up call, and as many of the window's first call.
TRAIN_STEPS = 3

#: The program's per-step streams the check compares, kept from its trace
#: hook; a decider's module may name more (``STREAMS``).
STREAMS = ("seeds", "remote", "missed", "placed", "hits", "replaced", "total_comm",
           "decisions", "feat_sums")

#: Keys of a configuration's ``agent`` that document it and set nothing.
AGENT_DOCS = ("source", "reduced", "assumed")

#: Host stages the traced call labels (for the idle gaps), by the
#: program's attribute that runs them.
STAGES = (
    ("repro_torch.runtime.stage", "SampleStage", "run_raw", "bench.sample"),
    ("repro_torch.runtime.stage", "DecisionStage", "collect", "bench.decision"),
    ("repro_torch.runtime.stage", "FusedFetchStage", "step_raw", "bench.fetch"),
    ("repro_torch.runtime.stage", "FusedFetchStage", "prime_raw", "bench.fetch"),
    ("repro_torch.runtime.driver", None, "train_step", "bench.train"),
)


@contextlib.contextmanager
def patched(owner, name, wrap):
    """``owner.name`` replaced by ``wrap(original)`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, wrap(old))
    try:
        yield
    finally:
        setattr(owner, name, old)


@dataclass
class Captured:
    """What the program produced in one call, on the host."""

    part_of: np.ndarray = None
    capacity: np.ndarray = None
    steps: list = field(default_factory=list)    # the trace hook's streams
    touched: list = field(default_factory=list)  # (P, Mt) per step
    snaps: list = field(default_factory=list)    # parameters after 0, 1, 3 steps
    losses: list = field(default_factory=list)
    first_grads: list = field(default_factory=list)  # per PE, the first step's
    buf_ids: np.ndarray = None
    buf_valid: np.ndarray = None
    buf_scores: np.ndarray = None


@dataclass
class RunOutput:
    correct: bool
    attempted: int
    metrics: dict
    device: dict
    checks: dict
    numbers: dict
    breakdown: dict | None = None
    controls: dict | None = None


def _recorder_class():
    from repro_torch.trace import TraceRecorder

    class StreamCapture(TraceRecorder):
        """The program's trace hook, keeping the raw streams ``keep`` of
        the first ``limit`` steps (all with ``None``)."""

        def __init__(self, num_pes, sink, limit, keep):
            super().__init__(num_pes=num_pes)
            self.sink, self.limit, self.keep = sink, limit, keep

        def record_step(self, **kw):
            if self.limit is not None and len(self.sink) >= self.limit:
                return
            self.sink.append({
                k: ([np.array(x) for x in kw[k]] if isinstance(kw[k], list) else np.array(kw[k]))
                for k in self.keep if kw.get(k) is not None
            })

        def finalize(self, epoch_times, events=None):
            return None

    return StreamCapture


def _params_host(model) -> list:
    return [p.detach().to("cpu", torch.float64).numpy().copy() for p in model.parameters()]


def agent_spec(cell: Cell, seed: int) -> dict | None:
    """The decider's settings where the configuration has an ``agent``:
    its name, the run's seed and the ``agent`` object; else None."""
    agent = cell.config.get("agent")
    if agent is None or not cell.traffic.get("decider"):
        return None
    return {"name": cell.traffic["decider"], "seed": int(seed), **agent}


def deciders(cell: Cell, seed: int, num_pes: int):
    """The trainer's ``deciders``: the bare name where the configuration
    has no ``agent``; else one of the program's agents a PE, all on one
    backend built from the settings (``make_backend(name, **settings)``,
    the documenting keys left out)."""
    name = cell.traffic.get("decider")
    spec = agent_spec(cell, seed)
    if spec is None:
        return [name] if name else None
    from repro_torch.core.agent import LLMAgent
    from repro_torch.core.backends import make_backend

    settings = {k: v for k, v in spec.items() if k != "name" and k not in AGENT_DOCS}
    backend = make_backend(name, **settings)
    return [LLMAgent(backend, None) for _ in range(num_pes)]


def build(cell: Cell, graph_arrays, init, seed: int, device):
    """The program's set-up: its ``Graph``, partition, store and trainer."""
    from repro_torch.gnn.sage import GraphSAGE
    from repro_torch.gnn.train import DistributedTrainer
    from repro_torch.graph.generate import Graph
    from repro_torch.graph.partition import partition_graph

    cfg, tr = cell.config, cell.traffic
    model_cfg = cfg["model"]
    g = Graph(
        name=cfg["name"],
        indptr=graph_arrays.indptr,
        indices=graph_arrays.indices,
        features=graph_arrays.features,
        labels=graph_arrays.labels,
        train_nodes=graph_arrays.train_nodes,
        num_classes=graph_arrays.num_classes,
        communities=graph_arrays.communities,
    )
    parts = partition_graph(g, int(cfg["num_pes"]))
    store = False
    if tr["store"]:
        from repro_torch.store import FeatureStore

        store = FeatureStore.for_partitions(parts, device=device, use_kernel=True)
    model = GraphSAGE(int(cfg["feature_dim"]), int(model_cfg["hidden_dim"]),
                      int(cfg["num_classes"])).to(device)
    with torch.no_grad():
        for p, w in zip(model.parameters(), init):
            p.copy_(w)
    trainer = DistributedTrainer(
        parts,
        variant=tr["variant"],
        deciders=deciders(cell, seed, int(cfg["num_pes"])),
        mode=tr["mode"],
        buffer_frac=float(tr["buffer_frac"]),
        batch_size=int(tr["batch_size"]),
        fanouts=tuple(int(f) for f in tr["fanouts"]),
        epochs=int(tr["epochs_per_call"]),
        lr=float(model_cfg["lr"]),
        hidden_dim=int(model_cfg["hidden_dim"]),
        train_model=True,
        seed=int(seed),
        device=device,
        feature_store=store,
        init_params=model,
    )
    B = trainer.batch_size
    if any(len(t) < B for t in trainer.local_train):
        raise ValueError(
            f"{cell.name}: a PE holds fewer train nodes than the batch; the raw "
            "device loop needs every PE's seed block at the batch size"
        )
    return trainer


class Capture:
    """The harness's captures around one ``run()`` call of ``trainer``:
    the program's streams through its trace hook and the raw ``(P, Mt)``
    frontier blocks of the first ``steps`` steps (all with ``None``) and
    the call's losses; with ``full``, also the partition and capacities,
    the parameters after 0, 1 and ``TRAIN_STEPS`` steps, the first step's
    per-PE gradients and the buffer at the call's end."""

    def __init__(self, trainer, steps: int | None = None, full: bool = False,
                 streams: tuple = STREAMS):
        self.trainer, self.limit, self.full, self.streams = trainer, steps, full, streams
        self.cap = Captured()
        self._stack = None

    def __enter__(self):
        from repro_torch.graph import sampler
        from repro_torch.runtime import driver

        trainer, cap, limit = self.trainer, self.cap, self.limit
        calls = [0]

        def capture_touched(fn):
            def wrapper(self, *a, **kw):
                out = fn(self, *a, **kw)
                if limit is None or len(cap.touched) < limit:
                    cap.touched.append(np.array(out[1]))
                return out
            return wrapper

        def capture_params(fn):
            def wrapper(tr, minibatches):
                loss = fn(tr, minibatches)
                calls[0] += 1
                if calls[0] in (1, TRAIN_STEPS):
                    cap.snaps.append(_params_host(tr.model))
                return loss
            return wrapper

        def capture_grads(fn):
            def wrapper(model, *a, **kw):
                loss, grads = fn(model, *a, **kw)
                if calls[0] == 0:
                    cap.first_grads.append([g.detach().to("cpu", torch.float64).numpy()
                                            for g in grads])
                return loss, grads
            return wrapper

        self._stack = contextlib.ExitStack()
        self._stack.enter_context(patched(sampler.SamplerPlane, "sample_all_raw",
                                          capture_touched))
        if self.full:
            cap.part_of = np.array(trainer.parts.part_of)
            cap.capacity = np.array(trainer.engine.capacity, dtype=np.int64)
            cap.snaps.append(_params_host(trainer.model))
            self._stack.enter_context(patched(driver, "train_step", capture_params))
            self._stack.enter_context(patched(type(trainer.model), "loss_and_grads",
                                              capture_grads))
        trainer.trace = _recorder_class()(trainer.parts.num_parts, cap.steps, limit,
                                          self.streams)
        return self

    def __exit__(self, *exc):
        self.trainer.trace = False
        self._stack.close()
        return False

    def finish(self, result) -> Captured:
        """Takes the call's losses (and, with ``full``, the buffer)."""
        cap = self.cap
        cap.losses = list(result.losses)[: self.limit]
        if self.full:
            eng = self.trainer.engine
            cap.buf_ids, cap.buf_valid = np.array(eng.ids), np.array(eng.valid)
            cap.buf_scores = np.array(eng.scores)
        return cap


def warm_up(trainer, streams: tuple = STREAMS) -> Captured:
    """The first ``run()`` call, with the program's streams captured."""
    capture = Capture(trainer, full=True, streams=streams)
    with capture:
        result = trainer.run()
    return capture.finish(result)


def next_call(trainer, capture: Capture, run=None):
    """``run()`` (or ``run(trainer)``) inside ``capture``: the result."""
    with capture:
        result = trainer.run() if run is None else run(trainer)
    capture.finish(result)
    return result


def seeds_per_s(steps: int, num_pes: int, batch: int, wall: float) -> float:
    """Training seeds of all PEs over the window's wall time: a seed
    counts once its step (sampled, prefetched, served, trained) is done."""
    return steps * num_pes * batch / wall


def steps_of(result) -> int:
    return len(result.logs[0].pct_hits)


# --------------------------------------------------------------------- #
# The traced call
# --------------------------------------------------------------------- #
class Costs:
    """Least seconds of each wrapped dispatcher's launches in the traced
    call, from each reader's ``cost(args, kwargs, out)``: bytes and
    operations, or a callable that gives them once the call is over."""

    def __init__(self):
        self.pending: dict = {}

    def add(self, name, cost):
        self.pending.setdefault(name, []).append(cost)

    def least_s(self) -> dict:
        from .roofline import bound

        out = {}
        for name, costs in self.pending.items():
            total = 0.0
            for c in costs:
                nbytes, nops = c() if callable(c) else c
                total += bound(nbytes, nops)
            out[name] = total
        return out


@contextlib.contextmanager
def traced_hooks(readers, costs: Costs):
    """``record_function`` ranges around the stages and around each
    dispatcher a reader names, from the harness's own files."""
    import importlib

    from repro_torch.kernels import ops

    def ranged(label):
        def wrap(fn):
            def wrapper(*a, **kw):
                with torch.profiler.record_function(label):
                    return fn(*a, **kw)
            return wrapper
        return wrap

    def costed(label, cost):
        def wrap(fn):
            def wrapper(*a, **kw):
                with torch.profiler.record_function(label):
                    out = fn(*a, **kw)
                costs.add(label, cost(a, kw, out))
                return out
            return wrapper
        return wrap

    with contextlib.ExitStack() as stack:
        for mod, cls, attr, label in STAGES:
            owner = importlib.import_module(mod)
            owner = getattr(owner, cls) if cls else owner
            stack.enter_context(patched(owner, attr, ranged(label)))
        for r in readers:
            name = getattr(r, "DISPATCHER", None)
            if name and f"bench.{name}" not in costs.pending:
                costs.pending[f"bench.{name}"] = []
                stack.enter_context(patched(ops, name, costed(f"bench.{name}", r.cost)))
        yield


def profiled_call(trainer, readers, cuda: bool,
                  capture: Capture) -> tuple[object, Profile, dict]:
    """One ``run()`` call under ``torch.profiler``, the traced hooks and
    ``capture``: ``(result, profile, least seconds by dispatcher
    range)``."""
    costs = Costs()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with traced_hooks(readers, costs):
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                result = next_call(trainer, capture)
                if cuda:
                    torch.cuda.synchronize()
    least = costs.least_s()
    stages = {label for *_, label in STAGES}
    prof_out = analyse(read_events(prof), list(least), stages)
    return result, prof_out, least


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


# --------------------------------------------------------------------- #
def window_calls(trainer, seconds: float, cuda: bool,
                 first: Capture | None = None) -> tuple[int, int, float]:
    """Start ``run()`` calls until ``seconds`` have passed, the first
    inside ``first`` when given: ``(calls, steps, wall seconds)``, the
    wall ending in a synchronise."""
    t0 = time.perf_counter()
    ends, steps = [], 0
    while time.perf_counter() - t0 < seconds:
        result = next_call(trainer, first) if first is not None and not ends else trainer.run()
        if cuda:
            torch.cuda.synchronize()
        steps += steps_of(result)
        ends.append(time.perf_counter() - t0)
    wall = time.perf_counter() - t0
    per_call = " ".join(f"{b - a:.3f}" for a, b in zip([0.0] + ends, ends))
    log(f"window {wall:.3f} s: {len(ends)} calls, {steps} steps; calls {per_call} s")
    return len(ends), steps, wall


def traced_metrics(cell: Cell, readers, session, prof_out, least, steps, P, B,
                   window=(0, 0.0)) -> dict:
    """The cell's per-layer metrics from the traced window's spans and
    counters, the profiled call, and ``window``: the steps and wall
    seconds of the calls after it; a reader that finds nothing is left
    out."""
    run = dict(
        spans=[(s.name, s.t0, s.t1) for s in session.tracer.spans],
        counters={
            n: session.registry[n].total
            for n in session.registry.names()
            if session.registry[n].kind == "counter"
        },
        steps=steps, seeds=steps * P * B, num_pes=P, batch=B,
        config=cell.config, traffic=cell.traffic, profile=prof_out, least_s=least,
        window_steps=window[0], window_s=window[1],
    )
    metrics = {}
    for m, reader in zip(cell.per_layer, readers):
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def check_call(cell: Cell, graph, init_host, seed: int, captured: Captured, nxt: Captured,
               num_pes: int, batch: int, device, controls: bool) -> tuple[dict, dict | None]:
    """The reference follows the warm-up call (``captured``) and the first
    steps of the next call (``nxt``): ``(numbers, controls)``."""
    t_check = time.perf_counter()
    cfg, tr = cell.config, cell.traffic
    store = bool(tr["store"])
    lr = float(cfg["model"]["lr"])
    ref = reference(cfg)
    rs = ref.setup(graph, num_pes, float(tr["buffer_frac"]), batch)
    per_call = int(tr["epochs_per_call"]) * rs.mb_per_epoch
    n_steps = [per_call, min(TRAIN_STEPS, per_call)]
    rules = cell.decider
    margins = hasattr(rules, "numbers")
    (ref_steps, ref_next), ref_bufs = ref.run_calls(
        graph, rs, seed, tr, batch, n_steps, store, min(512, len(graph.train_nodes)),
        agent=agent_spec(cell, seed), program=[captured.steps, nxt.steps],
        tie=float(cell.limits["agent_margin_gap"]) if margins else None,
    )
    numbers = check.exact_numbers(captured, nxt, rs, ref_steps, ref_next, ref_bufs, store)
    if margins:
        calls = (ref_steps, ref_next)
        numbers["decision_ties"] = int(sum(st.ties.sum() for c in calls for st in c))
        numbers.update(rules.numbers([captured.steps, nxt.steps],
                                     [[st.margins for st in c] for c in calls]))
    feats = torch.from_numpy(graph.features).to(device)
    labels = torch.from_numpy(graph.labels.astype(np.int64)).to(device)
    init_dev = [w.to(device) for w in init_host]
    k = min(TRAIN_STEPS, len(ref_steps))
    n1 = len(ref_steps)

    def host(leaves):
        return [q.detach().cpu().double().numpy() for q in leaves]

    def train_numbers(**kw):
        """The reference over the warm-up call's steps and the next call's
        first ones: the first steps' numbers and the next call's losses."""
        losses, snaps = ref.train_steps(init_dev, feats, labels, ref_steps + ref_next, lr, **kw)
        return losses[:k], [host(snaps[i]) for i in (0, 1, k)], losses[n1:]

    t_ref = time.perf_counter()
    ref_grads: list = []
    ref_losses, ref_snaps, ref_next_losses = train_numbers(first_grads=ref_grads)
    numbers.update(check.training_numbers(captured.losses, captured.snaps, ref_losses, ref_snaps, lr))
    numbers.update(check.next_call_numbers(nxt.losses, ref_next_losses))
    control_out = None
    if controls:
        control_out = {}
        for name, kw in (("tf32", dict(tf32=True)), ("half_batch", dict(fault="half_batch")),
                         ("no_exchange", dict(fault="no_exchange"))):
            c_losses, c_snaps, c_next = train_numbers(**kw)
            control_out[name] = check.training_numbers(c_losses, c_snaps, ref_losses, ref_snaps, lr)
            control_out[name].update(check.next_call_numbers(c_next, ref_next_losses))
        control_out["detail"] = check.leaf_detail(captured, ref_snaps, host(ref_grads), lr)
    log(f"check {time.perf_counter() - t_check:.3f} s (the GNN's {n1 + len(ref_next)} steps "
        f"{time.perf_counter() - t_ref:.3f} s)")
    return numbers, control_out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             window: bool = True, controls: bool = False) -> RunOutput:
    """One run. ``window=False`` runs, after the warm-up, only the call
    that the window would start with, then the check (the calibration of
    limits); ``controls`` also reads the control and the planted faults
    against the reference."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_setup = time.perf_counter()
    cfg = cell.config
    graph = generate.generate(cfg, seed, device)
    init = generate.init_weights(
        int(cfg["feature_dim"]), int(cfg["model"]["hidden_dim"]), int(cfg["num_classes"]),
        seed, device,
    )
    init_host = [w.detach().cpu() for w in init]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_gen = time.perf_counter() - t_setup
    trainer = build(cell, graph, init, seed, device)
    del init
    t_build = time.perf_counter() - t_setup - t_gen
    streams = STREAMS + tuple(getattr(cell.decider, "STREAMS", ()))
    captured = warm_up(trainer, streams)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    log(f"set-up {setup_s:.3f} s: graph {t_gen:.3f} s ({graph.num_nodes} nodes, "
        f"{len(graph.indices)} directed edges), program {t_build:.3f} s, warm-up call "
        f"{setup_s - t_gen - t_build:.3f} s ({len(captured.steps)} steps)")

    P, B = trainer.parts.num_parts, trainer.batch_size
    metrics, breakdown, steps = {}, None, 0
    device_out = {"platform": "gpu" if cuda else device.type,
                  "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1}
    nxt = Capture(trainer, steps=TRAIN_STEPS, streams=streams)
    if window and trace:
        from repro_torch.telemetry import TelemetrySession

        readers = [metric_reader(m["name"]) for m in cell.per_layer]
        session = TelemetrySession(label=cell.name, profile_kernels=False)
        trainer.telemetry = session
        result, prof_out, least = profiled_call(trainer, readers, cuda, nxt)
        _, w_steps, w_wall = window_calls(trainer, seconds, cuda)
        steps = steps_of(result) + w_steps
        trainer.telemetry = False
        metrics = traced_metrics(cell, readers, session, prof_out, least, steps, P, B,
                                 (w_steps, w_wall))
        device_out.update(busy_s=prof_out.busy_s, window_s=prof_out.window_s)
        breakdown = {"device_ops": prof_out.top_ops, "idle_gaps": prof_out.idle_by_host}
    elif window:
        _, steps, wall = window_calls(trainer, seconds, cuda, nxt)
    else:
        next_call(trainer, nxt)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    device_out["memory_peak_bytes"] = int(peak)
    if window and not trace:
        values = {"seeds_per_s": seeds_per_s(steps, P, B, wall),
                  "device_peak_gib": peak / 2**30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}

    # The check, once the window has closed and the program is freed.
    del trainer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, control_out = check_call(cell, graph, init_host, seed, captured, nxt.cap, P, B,
                                      device, controls)
    correct, checks = check.judge(numbers, cell.limits)
    return RunOutput(
        correct=correct,
        attempted=steps,
        metrics=metrics,
        device=device_out,
        checks=checks,
        numbers=numbers,
        breakdown=breakdown,
        controls=control_out,
    )
