"""Nested dicts, tuples and lists of tensors: their leaves and a map over
them, in the order `jax.tree` gives. Parameters, optimizer states, gradient
trees and argument shardings are such trees."""


def tree_leaves(tree) -> list:
    """The leaves of a nested dict/tuple/list, dict keys in sorted order (as
    `jax.tree.leaves` orders them)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)
