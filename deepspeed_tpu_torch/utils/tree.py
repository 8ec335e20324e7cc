"""Nested dict / list / tuple trees of tensors or arrays: the part of
``jax.tree_util`` the port needs for parameter, gradient and batch trees.

Dict entries are visited in sorted-key order, the order in which JAX
flattens a dict, so a leaf list lines up with the JAX package's.
"""

from typing import Callable, Iterable, Iterator


def tree_map(fn: Callable, *trees):
    """``fn`` applied leaf by leaf across trees of one structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> Iterator:
    """The leaves, dict entries in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for t in tree:
            yield from tree_leaves(t)
    else:
        yield tree


def tree_unflatten(like, leaves: Iterable):
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(like)
