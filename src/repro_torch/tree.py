"""Parameter trees: nested dicts, lists and tuples of tensors.

The port keeps parameters, gradients and optimizer moments as plain
nested containers (the reference's pytrees).  A leaf's path is the tuple
of dict keys and list indices that leads to it, e.g. ``("layers", 3,
"attn", "wq")``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["tree_map", "tree_map_with_path", "tree_leaves", "tree_leaves_with_path"]


def tree_map(fn: Callable[..., Any], tree, *rest):
    """``tree`` with each leaf replaced by ``fn(leaf, *the same leaf of rest)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable[[Tuple, Any], Any], tree, prefix: Tuple = ()):
    """``tree`` with each leaf replaced by ``fn(its path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_leaves_with_path(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in the tree's own order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves_with_path(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
