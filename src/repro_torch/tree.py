"""Nested trees of tensors: the port's one leaf walker.

A tree is a tensor, or a dict, list or tuple of trees. Leaves come in the
order ``jax.tree.leaves`` gives them (dict keys sorted, sequences in
order), so leaf lists line up with the reference's, and ``()`` has none.
"""
from __future__ import annotations

from typing import Dict


def tree_items(tree, prefix=()):
    """Leaves of a tree as ``[(path, tensor)]``: ``path`` is the tuple of
    dict keys and sequence indices down to the leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, t in enumerate(tree)
                for item in tree_items(t, prefix + (i,))]
    return [(prefix, tree)]


def tree_from_items(items):
    """``[(path, leaf)]`` of a tree of dicts -> the tree (a bare leaf for
    the path ``()``)."""
    out: Dict = {}
    for path, leaf in items:
        if not path:
            return leaf
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def tree_leaves(tree):
    """The leaves of ``tree``, in ``tree_items`` order."""
    return [leaf for _, leaf in tree_items(tree)]
