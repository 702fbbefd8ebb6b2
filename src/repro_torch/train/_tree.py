"""Nested containers of tensors: the port's stand-in for JAX's pytrees.

A tree is a tensor (or any other leaf), or a dict, list, tuple or
NamedTuple of trees.  Dicts keep their insertion order, as JAX's flatten
sorts nothing that the callers here rely on.
"""
from __future__ import annotations

from typing import Any, Callable, List


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree) -> List[Any]:
    """The leaves in order: dict values by key order of the first tree."""
    if isinstance(tree, dict):
        return [l for v in tree.values() for l in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which have its structure; the result has that structure too."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
