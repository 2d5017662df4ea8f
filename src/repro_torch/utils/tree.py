"""Nested dicts, lists and tuples of tensors: the port's parameter, gradient
and optimizer-state trees (the reference's pytrees).

``tree_leaves`` walks them in ``jax.tree_util``'s order (dict keys sorted,
sequences in order), so leaf lists line up with the JAX package's.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` on the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in ``jax.tree_util.tree_leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]
