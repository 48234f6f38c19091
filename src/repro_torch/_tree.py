"""Parameter trees of the port: nested dicts, lists, tuples and NamedTuples
whose leaves are tensors (the role ``jax.tree`` plays in the reference).  A
node whose class sets ``_tree_static`` (a decode state's ``CacheLayout``)
is structure, as a pytree's auxiliary data is: it holds no leaf, and a map
returns it as it is."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

PyTree = Any


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _is_static(node) -> bool:
    return getattr(type(node), "_tree_static", False)


def tree_map_with_path(fn: Callable, tree: PyTree, *rest: PyTree,
                       path: Tuple[str, ...] = ()) -> PyTree:
    """``fn(path, leaf, *leaves_of_rest)`` over every leaf of ``tree`` (the
    ``rest`` trees share its structure); ``path`` names the leaf by its keys,
    list indices and NamedTuple fields."""
    if _is_static(tree):
        return tree
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=path + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                               path=path + (f,))
                            for i, (f, v) in enumerate(zip(tree._fields, tree))))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest),
                                             path=path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def tree_leaves_with_path(tree: PyTree) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    found = []
    tree_map_with_path(lambda path, leaf: found.append((path, leaf)), tree)
    return iter(found)


def tree_leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
