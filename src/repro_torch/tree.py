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


def _flatten_into(t, leaves: List[Any]):
    if isinstance(t, dict):
        return ("dict", tuple((k, _flatten_into(t[k], leaves))
                              for k in sorted(t)))
    if isinstance(t, (tuple, list)):
        return (type(t), tuple(_flatten_into(x, leaves) for x in t))
    if t is None:
        return _NONE
    leaves.append(t)
    return _LEAF


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) in ``jax.tree.flatten`` order.

    The recursion is a module-level function, not a closure over
    ``leaves``: a recursive closure is a reference cycle, which would keep
    every leaf (full-size tensors) alive until the cyclic garbage
    collector happens to run."""
    leaves: List[Any] = []
    return leaves, _flatten_into(tree, leaves)


def _build(d, it):
    if d == _LEAF:
        return next(it)
    if d == _NONE:
        return None
    kind, children = d
    if kind == "dict":
        return {k: _build(c, it) for k, c in children}
    return kind(_build(c, it) for c in children)


def unflatten(treedef, leaves) -> Any:
    it = iter(leaves)
    out = _build(treedef, it)
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
