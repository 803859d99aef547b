"""Trees of tensors (nested dicts, lists, tuples and ``NamedTuple``\\ s),
flattened in the reference's order.

The reference flattens its pytrees with ``jax.tree_util.tree_flatten``:
dict keys sorted, list, tuple and ``NamedTuple`` children in order,
``None`` an empty node. The checkpoint format stores leaves in that
order, and the optimizer and the train step walk the leaves the same
way, so this module keeps it without importing JAX.
"""

from __future__ import annotations

_LEAF = "leaf"


def flatten(tree) -> tuple[list, tuple]:
    """``(leaves, spec)``: the leaves in the reference's order and the
    structure :func:`unflatten` rebuilds."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def _flatten(t, out: list):
    if t is None:
        return ("none",)
    if isinstance(t, dict):
        return ("dict", tuple(t), tuple((k, _flatten(t[k], out)) for k in sorted(t)))
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return ("namedtuple", type(t), tuple(_flatten(c, out) for c in t))
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, tuple(_flatten(c, out) for c in t))
    out.append(t)
    return _LEAF


def unflatten(spec, leaves):
    """The tree of ``spec`` holding ``leaves`` (in :func:`flatten`'s order);
    dicts keep the key order they were flattened with."""
    it = iter(leaves)
    tree = _build(spec, it)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return tree


def _build(spec, it):
    if spec == _LEAF:
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree holds") from None
    kind = spec[0]
    if kind == "none":
        return None
    if kind == "dict":
        built = {k: _build(s, it) for k, s in spec[2]}
        return {k: built[k] for k in spec[1]}
    if kind == "namedtuple":
        return spec[1](*(_build(s, it) for s in spec[2]))
    children = [_build(s, it) for s in spec[1]]
    return children if kind == "list" else tuple(children)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of trees of one structure."""
    leaves, spec = flatten(tree)
    others = []
    for t in rest:
        o, s = flatten(t)
        if s != spec:
            raise ValueError("trees of different structure")
        others.append(o)
    return unflatten(spec, [fn(*ls) for ls in zip(leaves, *others)])
