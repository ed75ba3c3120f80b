"""Nested containers of tensors (``repro``'s pytrees) in JAX's order.

``jax.tree`` flattens a dict by sorted key, a list or tuple in order and a
NamedTuple by field, and treats ``None`` as an empty node. The port's
parameter and state trees are plain dicts, lists and NamedTuples; a dict
keeps insertion order in Python, so each function here visits its keys
sorted, as JAX does. A sum over the leaves (``global_norm``) then adds
them in ``repro``'s order.
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves", "tree_map", "unflatten"]


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, list, tuple))


def leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over ``tree`` and trees of the same
    structure (``jax.tree.map``). Leaves are visited in :func:`leaves`'
    order; a dict keeps ``tree``'s key order, a NamedTuple its type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not _is_node(r) or len(r) != len(tree):
                raise ValueError("trees of different structure")
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        if isinstance(tree, list):
            return vals
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def unflatten(tree: Any, values) -> Any:
    """A tree of ``tree``'s structure holding ``values`` (in
    :func:`leaves`' order) at its leaves."""
    it = iter(values)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
