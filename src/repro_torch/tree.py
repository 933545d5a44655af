"""Nested dicts and lists of tensors (the port's params, grads and optimizer
moments), walked in one fixed order: dict keys sorted, as
`jax.tree_util` orders them, and list items in order."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """`leaves` (in `tree_leaves` order) put back in the structure of `like`."""
    it = iter(leaves)
    order = tree_map(lambda _: None, like)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(fill(v) for v in t)
        return next(it)
    out = fill(order)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
