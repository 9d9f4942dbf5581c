"""Nested parameter dicts (the encoded-field model's {"tables": {...}, W1,
...}) flattened in jax.tree_util's order: dict keys sorted, recursively.
The optimizer, the gradient clip and the checkpoints all use this order,
so every leaf is covered once and matches the JAX package's leaf order."""

from __future__ import annotations

from typing import Callable


def leaves(tree) -> list:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def map_tree(fn: Callable, tree):
    """The same nested dict with fn applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def unflatten(like, values: list):
    """`like`'s structure filled with `values` in leaves(like)'s order."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        return next(it)

    return build(like)
