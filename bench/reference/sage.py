"""Plain reference of the GraphSAGE training loop with a prefetch buffer.

Written from the semantics the program documents, in numpy and plain
torch; it imports nothing of the program. Given the benchmark's own graph
arrays, the cell's settings and the seed, it works out again, per
trainer PE (processing element):

* the partition (communities packed largest first into the smallest
  part), each PE's halo (distinct remote one-hop neighbours) and buffer
  capacity (``max(int(len(halo) * buffer_frac), 1)``);
* the seed blocks (a per-(epoch, PE) permutation of the PE's train
  nodes) and the fanout expansion, drawn from ``numpy``'s generator
  seeded with the run's seed, PE-major and layer-minor, with
  replacement and a self loop for isolated nodes;
* the replacement decisions, from each step's buffer metrics (hit
  share, misses, occupancy, the last round's churn, progress) by the
  traffic variant's rules in ``decisions/<variant>.py`` (an agent's, by
  its decider's in ``deciders/<decider>.py``); an empty buffer is always
  filled;
* the buffer: a lookup marks hits as accessed; a scoring round adds 1
  to accessed scores and multiplies the others by 0.95; a replacement
  round admits the previous step's misses (first occurrence order, not
  yet resident) into free slots and then slots whose score is below
  0.95, both in slot order, at score 1;
* the delivered remote rows of a step (the feature rows of its sorted
  remote set) and their float64 sum;
* GraphSAGE (mean aggregator, two layers, ReLU, cross entropy) trained
  data-parallel: per-PE gradients averaged over the PEs, one SGD step.

Calls follow one another on one trainer: each starts again at epoch 0
with no previous misses to admit, while the fanout generator, the
buffer and the deciders' memory carry over;
between two calls the program's accuracy pass draws its fanouts for its
seeds from the same generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as F

DECAY = np.float32(0.95)
STALE = np.float32(0.95)


# --------------------------------------------------------------------- #
# Partition, halos, train sets
# --------------------------------------------------------------------- #
def partition(communities: np.ndarray, num_parts: int) -> np.ndarray:
    """``part_of``: communities packed, largest first, each into the part
    that holds the fewest nodes so far (the first such part on a tie)."""
    num_comm = int(communities.max()) + 1
    sizes = np.bincount(communities, minlength=num_comm)
    loads = np.zeros(num_parts, dtype=np.int64)
    home = np.zeros(num_comm, dtype=np.int32)
    for c in np.argsort(-sizes):
        p = int(np.argmin(loads))
        home[c] = p
        loads[p] += sizes[c]
    return home[communities]


def halos(indptr, indices, part_of, num_parts) -> list[np.ndarray]:
    """Per PE the distinct neighbours, homed elsewhere, of its nodes."""
    src_part = np.repeat(part_of, np.diff(indptr))
    dst_part = part_of[indices]
    out = []
    for p in range(num_parts):
        sel = (src_part == p) & (dst_part != p)
        out.append(np.unique(indices[sel]))
    return out


def local_train(train_nodes, part_of, num_parts) -> list[np.ndarray]:
    return [train_nodes[part_of[train_nodes] == p] for p in range(num_parts)]


def seed_block(train_p: np.ndarray, epoch: int, p: int, mb: int, batch: int) -> np.ndarray:
    perm = np.random.default_rng((epoch * 1000003 + p) ^ 0xC0FFEE).permutation(len(train_p))
    start = (mb * batch) % len(train_p)
    idx = perm[start : start + batch]
    if len(idx) < min(batch, len(train_p)):
        idx = np.concatenate([idx, perm[: batch - len(idx)]])
    return train_p[idx]


def expand(indptr, indices, seeds: list[np.ndarray], fanouts, rng):
    """Fanout expansion of every PE's seeds. Returns ``(layers, touched)``:
    ``layers[l][p]`` is PE p's ``(n_l, f_l)`` neighbour block and
    ``touched[p]`` the seeds followed by every layer's neighbours."""
    P, B = len(seeds), len(seeds[0])
    counts, n = [], B
    for f in fanouts:
        counts.append((n, f))
        n *= f
    total = sum(a * b for a, b in counts)
    draws = [rng.random(total) for _ in range(P)]
    layers = [[] for _ in fanouts]
    touched = []
    for p in range(P):
        frontier = np.asarray(seeds[p], dtype=np.int64)
        off = 0
        parts = [frontier]
        for li, (m, f) in enumerate(counts):
            u = draws[p][off : off + m * f].reshape(m, f)
            off += m * f
            deg = indptr[frontier + 1] - indptr[frontier]
            pick = (u * np.maximum(deg, 1)[:, None]).astype(np.int64)
            pos = np.where(deg[:, None] > 0, indptr[frontier][:, None] + pick, 0)
            nbrs = np.where(deg[:, None] > 0, indices[pos], frontier[:, None])
            layers[li].append(nbrs)
            frontier = nbrs.reshape(-1)
            parts.append(frontier)
        touched.append(np.concatenate(parts))
    return layers, touched


# --------------------------------------------------------------------- #
# The buffer
# --------------------------------------------------------------------- #
class Buffer:
    """One PE's buffer: per slot its node, score, validity and whether it
    was accessed this round; ``slot_of`` maps a node to its slot (-1 when
    not resident)."""

    def __init__(self, capacity: int, num_nodes: int):
        self.capacity = c = capacity
        self.ids = np.full(c, -1, dtype=np.int64)
        self.scores = np.zeros(c, dtype=np.float32)
        self.valid = np.zeros(c, dtype=bool)
        self.accessed = np.zeros(c, dtype=bool)
        self.slot_of = np.full(num_nodes, -1, dtype=np.int64)

    def lookup(self, remote: np.ndarray) -> np.ndarray:
        slots = self.slot_of[remote]
        hit = slots >= 0
        self.accessed[slots[hit]] = True
        return hit

    def score_round(self) -> None:
        upd = np.where(self.accessed, self.scores + np.float32(1.0), self.scores * DECAY)
        self.scores = np.where(self.valid, upd, self.scores).astype(np.float32)
        self.accessed[:] = False

    def replace(self, candidates: np.ndarray) -> np.ndarray:
        _, first = np.unique(candidates, return_index=True)
        cand = candidates[np.sort(first)]
        cand = cand[self.slot_of[cand] < 0]
        free = np.nonzero(~self.valid)[0]
        stale = np.nonzero(self.valid & (self.scores < STALE))[0]
        slots = np.concatenate([free, stale])[: len(cand)]
        placed = cand[: len(slots)]
        evicted = self.ids[slots][self.valid[slots]]
        self.slot_of[evicted] = -1
        self.slot_of[placed] = slots
        self.ids[slots] = placed
        self.scores[slots] = np.float32(1.0)
        self.valid[slots] = True
        self.accessed[slots] = False
        return placed

    def copy(self) -> "Buffer":
        out = Buffer.__new__(Buffer)
        out.capacity = self.capacity
        for name in ("ids", "scores", "valid", "accessed", "slot_of"):
            setattr(out, name, getattr(self, name).copy())
        return out


# --------------------------------------------------------------------- #
# The decisions
# --------------------------------------------------------------------- #
def make_deciders(traffic: dict, num_pes: int, agent: dict | None = None, seed: int = 0):
    """Per PE the decider of the traffic's variant, from
    ``bench/reference/decisions/<variant>.py``: an object whose
    ``tick(t, metrics, program, tie)`` answers ``(replace, margin,
    followed)`` for step t of a call (see ``decisions/rudder.py``), and
    whose ``new_call()`` starts a call; ``None`` where the variant keeps
    no buffer. ``agent`` is the decider's settings (the configuration's
    ``agent`` with its name and the run's seed), or None."""
    import importlib.util

    path = Path(__file__).resolve().parent / "decisions" / f"{traffic['variant']}.py"
    spec = importlib.util.spec_from_file_location(f"bench_decisions_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make(traffic, num_pes, agent, seed)


# --------------------------------------------------------------------- #
# The loop of one call
# --------------------------------------------------------------------- #
@dataclass
class Step:
    seeds: list             # per PE (B,)
    layers: list            # per layer, per PE
    touched: list           # per PE (Mt,)
    remote: list            # per PE, sorted
    hits: np.ndarray        # (P,)
    missed: list            # per PE
    placed: list            # per PE
    replaced: np.ndarray    # (P,)
    total_comm: np.ndarray  # (P,)
    decisions: np.ndarray   # (P,) bool
    feat_sums: np.ndarray | None = None
    margins: np.ndarray | None = None  # (P,) the answers' margins, NaN where none
    ties: np.ndarray | None = None     # (P,) bool: the program's decision followed


@dataclass
class Setup:
    part_of: np.ndarray
    capacity: np.ndarray
    train: list
    mb_per_epoch: int


def setup(graph, num_parts: int, buffer_frac: float, batch: int) -> Setup:
    part_of = partition(graph.communities, num_parts)
    halo = halos(graph.indptr, graph.indices, part_of, num_parts)
    capacity = np.array([max(int(len(h) * buffer_frac), 1) for h in halo], dtype=np.int64)
    train = local_train(graph.train_nodes, part_of, num_parts)
    mb = max(1, max((len(t) + batch - 1) // batch for t in train if len(t)))
    return Setup(part_of, capacity, train, mb)


def run_calls(graph, s: Setup, seed: int, traffic: dict, batch: int, steps: list,
              store: bool, acc_nodes: int, *, agent: dict | None = None,
              program: list | None = None, tie: float | None = None):
    """The first ``steps[c]`` steps of each call ``c`` in turn on one
    fresh trainer of ``traffic`` (``epochs_per_call`` epochs a call):
    returns ``(steps, buffers)``, ``steps[c]`` the :class:`Step` s of
    call ``c`` and ``buffers`` each PE's buffer at the end of the first
    call. ``acc_nodes`` is the number of seeds of the accuracy pass that
    ends each call. ``agent`` is handed to the deciders; ``program[c]``,
    the program's per-step streams of call ``c``, gives the decision an
    agent takes at a tie (an answer whose margin is within ``tie``)."""
    P = len(s.train)
    fanouts = tuple(int(f) for f in traffic["fanouts"])
    rng = np.random.default_rng(seed)
    bufs = [Buffer(int(c), len(graph.indptr) - 1) for c in s.capacity]
    deciders = make_deciders(traffic, P, agent, seed)
    total = int(traffic["epochs_per_call"]) * s.mb_per_epoch
    out, first_bufs = [], None
    for c, n_steps in enumerate(steps):
        if c:
            # The previous call's accuracy pass: one draw per layer.
            m = acc_nodes
            for f in fanouts:
                rng.random(m * f)
                m *= f
        for d in deciders or ():
            d.new_call()
        prog = program[c] if program is not None and c < len(program) else []
        out.append(_call_steps(graph, s, rng, bufs, fanouts, batch, deciders, total,
                               n_steps, store, prog, tie))
        if c == 0:
            first_bufs = [b.copy() for b in bufs]
    return out, first_bufs


def _program_decision(prog, t: int, p: int):
    if t < len(prog) and "decisions" in prog[t] and p < len(prog[t]["decisions"]):
        return bool(prog[t]["decisions"][p])
    return None


def _call_steps(graph, s, rng, bufs, fanouts, batch, deciders, total, steps, store,
                prog=(), tie=None):
    P = len(s.train)
    prev_missed = [np.zeros(0, dtype=np.int64) for _ in range(P)]
    last_replaced = None
    out = []
    for t in range(steps):
        epoch, mb = divmod(t, s.mb_per_epoch)
        seeds = [seed_block(s.train[p], epoch, p, mb, batch) for p in range(P)]
        layers, touched = expand(graph.indptr, graph.indices, seeds, fanouts, rng)
        remote, hits, missed, placed = [], np.zeros(P, np.int64), [], []
        replaced = np.zeros(P, np.int64)
        decisions = np.zeros(P, dtype=bool)
        margins = np.full(P, np.nan)
        ties = np.zeros(P, dtype=bool)
        sums = np.zeros(P, dtype=np.float64) if store else None
        for p in range(P):
            u = np.unique(touched[p])
            r = u[s.part_of[u] != p]
            remote.append(r)
            if deciders is not None:
                hit = bufs[p].lookup(r)
            else:
                hit = np.zeros(len(r), dtype=bool)
            hits[p] = int(hit.sum())
            missed.append(r[~hit])
            got = np.zeros(0, np.int64)
            if deciders is not None:
                cap = bufs[p].capacity
                occupancy = int(bufs[p].valid.sum()) / max(cap, 1)
                metrics = dict(
                    pct_hits=float(100.0 * hits[p] / max(len(r), 1)) if len(r) else 100.0,
                    comm=len(missed[p]),
                    occupancy=occupancy,
                    replaced_pct=0.0 if last_replaced is None
                    else float(100.0 * last_replaced[p] / max(cap, 1.0)),
                    capacity=cap,
                    progress=t / total,
                    minibatch=mb,
                    epoch=epoch,
                )
                replace, margin, ties[p] = deciders[p].tick(
                    t, metrics, _program_decision(prog, t, p), tie)
                if margin is not None:
                    margins[p] = margin
                decisions[p] = replace or occupancy == 0.0
                bufs[p].score_round()
                if decisions[p]:
                    got = bufs[p].replace(prev_missed[p])
            placed.append(got)
            replaced[p] = len(got)
            prev_missed[p] = missed[p]
            if store:
                sums[p] = graph.features[r].sum(dtype=np.float64)
        last_replaced = replaced
        total_comm = np.array([len(m) for m in missed], dtype=np.int64) + replaced
        out.append(Step(seeds, layers, touched, remote, hits, missed, placed,
                        replaced, total_comm, decisions, sums, margins, ties))
    return out


# --------------------------------------------------------------------- #
# GraphSAGE
# --------------------------------------------------------------------- #
def sage_loss(params, x_seed, x_n1, n2_mean, labels):
    w1s, w1n, b1, w2s, w2n, b2 = params
    h_n1 = torch.relu(x_n1 @ w1s + n2_mean @ w1n + b1)
    h_seed = torch.relu(x_seed @ w1s + x_n1.mean(dim=1) @ w1n + b1)
    logits = h_seed @ w2s + h_n1.mean(dim=1) @ w2n + b2
    return F.cross_entropy(logits, labels)


def pe_inputs(features: torch.Tensor, labels: torch.Tensor, seeds, layers, p):
    """One PE's ``(x_seed, x_n1, n2_mean, labels)`` from the plain table."""
    dev = features.device
    s = torch.from_numpy(seeds[p]).to(dev)
    n1 = torch.from_numpy(layers[0][p]).to(dev)
    n2 = torch.from_numpy(layers[1][p]).to(dev)
    b, f1 = n1.shape
    x_n2 = features[n2.reshape(-1)].reshape(b, f1, n2.shape[1], -1)
    return features[s], features[n1], x_n2.mean(dim=2), labels[s]


def train_steps(params, features, labels, steps, lr: float, *, tf32: bool = False,
                fault: str | None = None, first_grads: list | None = None):
    """Data-parallel SGD over ``steps`` (each a :class:`Step`): returns
    ``(losses, snapshots)`` where ``snapshots[k]`` holds the parameters
    after ``k`` steps (``snapshots[0]`` the initial ones). ``tf32`` runs
    the products in TF32 on a card (the control); ``fault`` plants one of
    the faults a check has to catch: ``"half_batch"`` (each PE trains on
    the first half of its seeds), ``"no_exchange"`` (PE 0's gradient
    alone is applied), ``"unchanged"`` (no update). ``first_grads``, when
    given, receives the first step's averaged gradient."""
    params = [p.detach().clone() for p in params]
    snaps = [[p.clone() for p in params]]
    losses = []
    cuda = features.device.type == "cuda"
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32 and cuda
    torch.backends.cudnn.allow_tf32 = tf32 and cuda
    try:
        for st in steps:
            P = len(st.seeds)
            acc, loss_acc = None, 0.0
            for p in range(P):
                leaves = [q.clone().requires_grad_(True) for q in params]
                x_seed, x_n1, n2_mean, lab = pe_inputs(features, labels, st.seeds, st.layers, p)
                if fault == "half_batch":
                    h = len(lab) // 2
                    x_seed, x_n1, n2_mean, lab = x_seed[:h], x_n1[:h], n2_mean[:h], lab[:h]
                if tf32 and not cuda:
                    x_seed, x_n1, n2_mean = (round_tf32(x) for x in (x_seed, x_n1, n2_mean))
                    leaves_in = [round_tf32(q) for q in leaves]
                else:
                    leaves_in = leaves
                loss = sage_loss(leaves_in, x_seed, x_n1, n2_mean, lab)
                grads = torch.autograd.grad(loss, leaves)
                loss_acc += float(loss.detach()) / P
                if fault == "no_exchange":
                    if p == 0:
                        acc = [g * P for g in grads]
                    continue
                acc = list(grads) if acc is None else [a + g for a, g in zip(acc, grads)]
            if first_grads is not None and not first_grads:
                first_grads.extend(g / P for g in acc)
            if fault != "unchanged":
                with torch.no_grad():
                    for q, g in zip(params, acc):
                        q.sub_(lr * (g / P))
            losses.append(loss_acc)
            snaps.append([q.clone() for q in params])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    return losses, snaps


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10-bit mantissa (nearest, ties away), the
    CPU's stand-in for the card's TF32 products; keeps autograd through
    a straight-through difference."""
    bits = x.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (r - x.detach())
