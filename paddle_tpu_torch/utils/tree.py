"""Walks of nested parameter trees under jax.tree_util's rules: a dict
(its keys sorted), a list and a tuple are containers, anything else is a
leaf, a tuple subclass included (a PartitionSpec, a torch.Size), as jax
takes its own PartitionSpec for a leaf. One rule for the whole package,
so a tree of tensors, of shapes and of specs walk alike."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List

__all__ = ["leaves", "tree_map", "rebuild"]


def _container(tree) -> bool:
    return type(tree) in (list, tuple)


def leaves(tree) -> List[Any]:
    """The leaves of `tree` in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in leaves(tree[key])]
    if _container(tree):
        return [t for x in tree for t in leaves(x)]
    return [tree]


def tree_map(fn: Callable, tree):
    """`tree`'s nesting (dict key order and container types kept) with
    `fn` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if _container(tree):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def rebuild(tree, items: Iterator):
    """`tree`'s nesting with its leaves replaced, in `leaves` order, by
    the items of the iterator `items`."""
    if isinstance(tree, dict):
        out = {k: rebuild(tree[k], items) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _container(tree):
        return type(tree)(rebuild(x, items) for x in tree)
    return next(items)
