"""Helpers for param trees: nested ``dict``s with tensor leaves.

Counterpart of the pytree helpers the slice needs from ``repro/utils/tree.py``
and ``repro/models/module.py``.  Keys are walked in sorted order, the order
``jax.tree_util`` uses for dicts, so a reduction over the leaves (a global
norm, say) adds them in the same order in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List

import torch


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over trees of the same structure.  A
    ``NamedTuple`` (a ``TrainState``) is walked field by field, in order,
    and a None field stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(
            None if t is None else tree_map(fn, t, *(r[i] for r in rest))
            for i, t in enumerate(tree)))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in ``jax.tree_util`` order: dict keys sorted, lists and tuples
    in order, None holding no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if tree is None:
        return []
    return [tree]


def tree_unflatten(like: Any, leaves: Iterator) -> Any:
    """The structure of ``like`` filled from the iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(tree_unflatten(t, leaves) for t in like))
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(t, leaves) for t in like)
    if like is None:
        return None
    return next(leaves)


def tree_lerp(a: Any, b: Any, w) -> Any:
    """(1-w)*a + w*b, leafwise."""
    return tree_map(lambda x, y: (1.0 - w) * x + w * y, a, b)


def tree_where(pred: torch.Tensor, a: Any, b: Any) -> Any:
    """Select whole trees by a scalar bool tensor, leafwise ``torch.where``
    (no host read of ``pred``)."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_clone(tree: Any) -> Any:
    return tree_map(torch.clone, tree)
