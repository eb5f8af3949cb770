"""Nested-container helpers over parameter trees (dicts, tuples, lists).

Leaf order follows ``jax.tree.flatten``: dict keys sorted, tuples and
lists in order, ``None`` an empty subtree. Keeping that order is what lets
``engine.flat.FlatSpec`` give the same offsets as the JAX package's spec,
so a flat buffer here equals ``FlatSpec.flatten`` of the reference tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

_LEAF = ("leaf",)
_NONE = ("none",)


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) in ``jax.tree.flatten`` order."""
    leaves: List[Any] = []

    def rec(t):
        if isinstance(t, dict):
            return ("dict", tuple((k, rec(t[k])) for k in sorted(t)))
        if isinstance(t, (tuple, list)):
            return (type(t), tuple(rec(x) for x in t))
        if t is None:
            return _NONE
        leaves.append(t)
        return _LEAF

    return leaves, rec(tree)


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)

    def rec(d):
        if d == _LEAF:
            return next(it)
        if d == _NONE:
            return None
        kind, children = d
        if kind == "dict":
            return {k: rec(c) for k, c in children}
        return kind(rec(c) for c in children)

    out = rec(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def map(fn: Callable, tree, *rest) -> Any:  # noqa: A001 (mirrors jax.tree.map)
    """``fn`` over corresponding leaves of trees with one structure."""
    ls, td = flatten(tree)
    others = [flatten(r) for r in rest]
    for ol, otd in others:
        if otd != td:
            raise ValueError("tree structures differ")
    return unflatten(td, [fn(*xs) for xs in zip(ls, *(o[0] for o in others))])
