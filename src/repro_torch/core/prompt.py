"""Structured prompt construction (paper §4.3.2, Fig. 10).

Zero-shot ICL prompting: a structured task definition with the system
description, task objective, metric explanations, current state,
replacement history, and graph metadata. The expected answer is JSON:

    {"action": "replace" | "skip",
     "expected_hits": "up" | "flat" | "down",
     "reason": "..."}

The prompt is real and complete — a deployment against Ollama (see
``backends.OllamaBackend``) sends exactly this text. The in-container
surrogate backends consume the same structured fields.
"""

from __future__ import annotations

import json

from .metrics import GraphMeta, HistoryEntry, Metrics

SYSTEM_DESCRIPTION = """\
You are the replacement controller of a distributed GNN training system.
Each trainer holds a fixed-size persistent buffer of remote node features.
A scoring policy tracks usage: accessed nodes gain +1 score, unaccessed
nodes decay by x0.95 per round, and nodes below 0.95 are stale and can be
replaced by recently sampled remote nodes. Your job is to decide, for the
next minibatch, whether to trigger a replacement round (action=replace)
or keep the buffer as-is (action=skip)."""

METRIC_GLOSSARY = """\
Metric meanings:
- pct_hits: percent of sampled remote nodes found in the local buffer
  (higher is better; low or stagnating pct_hits with rising communication
  suggests the buffer content is no longer relevant).
- comm_volume: number of remote node features fetched over the network
  this minibatch (lower is better).
- replaced_pct: nodes replaced in the last replacement round as a percent
  of buffer capacity (near zero means replacements are not finding stale
  nodes and are wasted work).
- progress: fraction of total training completed. Replacements near
  completion cannot amortize their cost and should be avoided."""

ANSWER_FORMAT = """\
Answer with a single JSON object and nothing else:
{"action": "replace" or "skip",
 "expected_hits": "up", "flat" or "down",
 "reason": "<one short sentence>"}"""


def format_history(history: list[HistoryEntry], max_entries: int = 5) -> str:
    if not history:
        return "No replacement decisions have been made yet."
    lines = []
    for h in history[-max_entries:]:
        outcome = (
            f"pct_hits {h.pre_pct_hits:.1f} -> {h.post_pct_hits:.1f}, "
            f"comm {h.pre_comm_volume} -> {h.post_comm_volume}"
            if h.evaluated
            else "outcome pending"
        )
        lines.append(
            f"- minibatch {h.minibatch}: "
            f"{'REPLACE' if h.decision else 'SKIP'} "
            f"(predicted hits {h.predicted_hits_direction}); {outcome}"
        )
    return "\n".join(lines)


_TASK = (
    "Task: decide whether to trigger a replacement round for the "
    "next minibatch, and state your expected effect on pct_hits so "
    "the outcome can be checked against your prediction."
)


def _meta_block(graph: GraphMeta) -> str:
    meta = {
        "graph": graph.name,
        "num_nodes": graph.num_nodes,
        "num_edges": graph.num_edges,
        "partition_nodes": graph.part_nodes,
        "partition_edges": graph.part_edges,
        "num_partitions": graph.num_partitions,
    }
    return "Graph metadata (static):\n" + json.dumps(meta, indent=1)


def _state_block(metrics: Metrics, recent_hits: list[float] | None) -> str:
    state = {
        "minibatch": metrics.minibatch,
        "total_minibatches": metrics.total_minibatches,
        "epoch": metrics.epoch,
        "total_epochs": metrics.total_epochs,
        "progress": round(metrics.progress, 4),
        "pct_hits": round(metrics.pct_hits, 2),
        "comm_volume": metrics.comm_volume,
        "replaced_pct": round(metrics.replaced_pct, 2),
        "buffer_occupancy": round(metrics.buffer_occupancy, 3),
        "buffer_capacity": metrics.buffer_capacity,
    }
    if recent_hits is not None:
        state["recent_pct_hits"] = [round(h, 2) for h in recent_hits[-8:]]
    return "Current state:\n" + json.dumps(state, indent=1)


def _assemble(meta_block: str, state_block: str, history_block: str) -> str:
    return "\n\n".join(
        [
            SYSTEM_DESCRIPTION,
            METRIC_GLOSSARY,
            meta_block,
            state_block,
            history_block,
            _TASK,
            ANSWER_FORMAT,
        ]
    )


def build_prompt(
    metrics: Metrics,
    history: list[HistoryEntry],
    graph: GraphMeta,
    recent_hits: list[float] | None = None,
) -> str:
    """Assemble the full structured prompt for the DECISION MAKER."""
    return _assemble(
        _meta_block(graph),
        _state_block(metrics, recent_hits),
        "Replacement history (most recent last):\n" + format_history(history),
    )


def build_prompt_batch(
    metrics_list: list[Metrics],
    histories: list[list[HistoryEntry]],
    graphs: list[GraphMeta],
    recent_hits_lists: list[list[float] | None],
) -> list[str]:
    """Assemble one prompt per PE in a single pass.

    Byte-identical to per-element :func:`build_prompt`; the static
    sections are shared and the graph-metadata block is rendered once per
    distinct :class:`GraphMeta` (PEs of one job share partition shapes
    far more often than not).
    """
    meta_cache: dict[GraphMeta, str] = {}
    out = []
    for metrics, history, graph, recent_hits in zip(
        metrics_list, histories, graphs, recent_hits_lists
    ):
        meta = meta_cache.get(graph)
        if meta is None:
            meta = meta_cache[graph] = _meta_block(graph)
        out.append(
            _assemble(
                meta,
                _state_block(metrics, recent_hits),
                "Replacement history (most recent last):\n"
                + format_history(history),
            )
        )
    return out
