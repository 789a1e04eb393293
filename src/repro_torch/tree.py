"""Trees of tensors: nested dicts, lists, tuples and NamedTuples (the
port's parameter trees, ``TrainState`` and ``AdamWState``), the
counterpart of the ``jax.tree`` functions the reference's training uses.

Leaves are visited in the tree's own order: a dict's insertion order, a
list's or tuple's index order.  A leaf's name joins the keys, indices and
field names on its path with ``_`` (``params_blocks_0_attn_wq_w``), as the
reference's checkpointer names its leaves.
"""
from __future__ import annotations

from typing import Any, Callable


def _children(tree):
    """(names, children) of a tree node, or None for a leaf."""
    if isinstance(tree, dict):
        return list(tree.keys()), list(tree.values())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree._fields), list(tree)
    if isinstance(tree, (list, tuple)):
        return [str(i) for i in range(len(tree))], list(tree)
    return None


def _rebuild(like, children: list):
    if isinstance(like, dict):
        return dict(zip(like.keys(), children))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*children)
    return type(like)(children)


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of ``tree``, the tree's structure kept."""
    node = _children(tree)
    if node is None:
        return fn(tree)
    return _rebuild(tree, [tree_map(fn, c) for c in node[1]])


def tree_flatten(tree, prefix: str = "") -> tuple[list[str], list[Any]]:
    """(names, leaves) of ``tree`` in its order."""
    node = _children(tree)
    if node is None:
        return [prefix], [tree]
    names, leaves = [], []
    for key, child in zip(*node):
        n, lv = tree_flatten(child, f"{prefix}_{key}" if prefix else str(key))
        names += n
        leaves += lv
    return names, leaves


def tree_leaves(tree) -> list[Any]:
    return tree_flatten(tree)[1]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in its order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
