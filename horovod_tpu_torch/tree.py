"""Containers of tensors as trees: dicts (walked in sorted key order),
lists, tuples and NamedTuples; anything else is a leaf.  The one walker
of the port's checkpoints, step guard and ZeRO-1 state."""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def children(x) -> Optional[Tuple[Any, list, list]]:
    """(rebuild, keys, children) of a container; None for a leaf."""
    if isinstance(x, dict):
        try:
            keys = sorted(x)
        except TypeError:
            keys = sorted(x, key=str)
        return (lambda ch, k=keys: dict(zip(k, ch))), keys, [x[k] for k in
                                                               keys]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (lambda ch, t=type(x): t(*ch)), list(x._fields), list(x)
    if isinstance(x, (list, tuple)):
        return ((lambda ch, t=type(x): t(ch)), list(range(len(x))),
                list(x))
    return None


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the same places of
    ``rest``); None stays None, as an empty subtree."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    node = children(tree)
    if node is None:
        return fn(tree, *rest)
    rebuild, _, kids = node
    others = [children(r)[2] for r in rest]
    return rebuild([tree_map(fn, c, *[o[i] for o in others],
                             is_leaf=is_leaf)
                    for i, c in enumerate(kids)])


def tree_leaves_with_path(tree, prefix: Tuple = ()) -> List[Tuple[Tuple,
                                                                   Any]]:
    """``(path, leaf)`` for every leaf, in the fixed order of
    :func:`tree_map`."""
    if tree is None:
        return []
    node = children(tree)
    if node is None:
        return [(prefix, tree)]
    _, keys, kids = node
    out = []
    for k, c in zip(keys, kids):
        out.extend(tree_leaves_with_path(c, prefix + (k,)))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]
