"""Nested dicts, lists and tuples of tensors as trees, in ``jax.tree``'s
order.

A tree is a tensor (a leaf), ``None`` (no leaf: adafactor's column moment
of a 1-D leaf), or a dict, list or tuple of trees.  Leaves are visited as
``jax.tree_util`` visits them — dict keys sorted, sequences in order — so
:func:`flatten_with_paths` gives the JAX package's checkpoint keys
(``opt/m/layers/attn/wq``, ``opt/moments/embed/tok/0``).
"""
from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_leaves", "flatten_with_paths", "unflatten"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *matching)`` over every leaf of ``tree``; each tree of
    ``rest`` is read at the same place, and where ``tree`` has a leaf it
    hands over its whole subtree there (``flatten_up_to``).  ``None``
    stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def flatten_with_paths(tree: Any, prefix: str = "") -> list:
    """``[(key, leaf)]`` in ``jax.tree_util.tree_flatten_with_path``'s
    order, each key the ``/``-joined dict keys and sequence indices."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif tree is None:
        return []
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Any, leaves: dict, prefix: str = "") -> Any:
    """The tree of ``like``'s structure whose leaf at each key is
    ``leaves[key]``."""
    if isinstance(like, dict):
        return {k: unflatten(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(
            unflatten(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(like))
    if like is None:
        return None
    return leaves[prefix]
