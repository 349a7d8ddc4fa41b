"""Nested containers of tensors (the port's parameter trees).

Parameters, gradients and Adam moments are nested dicts / lists of tensors in
the JAX package's layout (``models/mlp.py`` there). Leaves are visited with
dict keys sorted, as ``jax.tree.leaves`` visits them, so the i-th leaf of a
port tree is the i-th leaf of the matching JAX pytree. ``None`` is an empty
subtree (a missing fine network), as in JAX.
"""

from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of ``rest``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like, leaves):
    """Tree of ``like``'s structure holding ``leaves`` (in tree_leaves order)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)
