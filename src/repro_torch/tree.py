"""Nested dicts, lists and tuples of tensors: the port's pytrees.

The JAX package walks its parameter and optimizer trees with ``jax.tree``;
the port's trees are plain containers with tensor leaves.  Dict keys are
visited in sorted order, as ``jax.tree`` visits them, and list items in
order.  A path is the tuple of keys and indices from the root to a leaf.
"""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_leaves_with_path",
           "tree_map_with_path"]


def _children(tree):
    if isinstance(tree, dict):
        return [(key, tree[key]) for key in sorted(tree)]
    return list(enumerate(tree))


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of the trees ``rest`` of
    the same structure), in a tree of the same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, v, *(r[key] for r in rest))
                for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves, in a tree of the same
    structure."""
    if isinstance(tree, dict):
        return {key: tree_map_with_path(fn, v, path + (key,))
                for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_path(tree, path=()) -> list:
    """[(path, leaf)] in ``jax.tree`` order."""
    if not _is_node(tree):
        return [(path, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(tree_leaves_with_path(child, path + (key,)))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
