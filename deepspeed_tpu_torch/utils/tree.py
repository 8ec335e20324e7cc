"""Nested dict / list / tuple / NamedTuple trees of tensors or arrays: the
part of ``jax.tree_util`` the port needs for parameter, gradient, batch
and checkpoint trees.

Leaves are visited in JAX's order: dict entries by sorted key, sequences
by index, NamedTuples by field, so a leaf list lines up with the JAX
package's. None is an empty subtree, as in JAX: it holds no leaf and maps
to None.
"""

from typing import Callable, Iterable, Iterator, Tuple


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn: Callable, *trees):
    """``fn`` applied leaf by leaf across trees of one structure."""
    t0 = trees[0]
    if t0 is None:
        return None
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        mapped = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*mapped) if _is_namedtuple(t0) else type(t0)(mapped)
    return fn(*trees)


def tree_map_with_path(fn: Callable[[Tuple[str, ...], object], object],
                       tree):
    """``tree`` rebuilt with each leaf replaced by ``fn(path, leaf)``, in
    :func:`tree_leaves` order: ``path`` is the tuple of dict keys,
    sequence indices (both as strings) and NamedTuple field names down
    to the leaf."""
    def walk(t, path):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(t[k], path + (str(k),)) for k in sorted(t)}
        if _is_namedtuple(t):
            return type(t)(*(walk(v, path + (name,))
                             for name, v in zip(t._fields, t)))
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (str(i),))
                           for i, v in enumerate(t))
        return fn(path, t)
    return walk(tree, ())


def tree_leaves(tree) -> Iterator:
    """The leaves, in JAX's order."""
    leaves = []
    tree_map_with_path(lambda _, leaf: leaves.append(leaf), tree)
    return iter(leaves)


def tree_unflatten(like, leaves: Iterable):
    """A tree shaped like ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map_with_path(lambda _, __: next(it), like)
