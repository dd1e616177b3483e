"""Nested-dict trees: the cache and parameter trees the port passes around,
laid out like the reference's pytrees. Lists (a layer group's per-layer
entries) are nodes too, in order; dict keys flatten in sorted order, as
``jax.tree_util`` flattens dicts."""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf-wise over one or more trees of equal structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_flatten_with_keys(tree: Any, sep: str = ".") -> list:
    """``[(key, leaf), ...]`` in ``jax.tree_util`` order, each key the path's
    dict keys and list indices joined by ``sep`` (the reference checkpoint's
    leaf names)."""
    out: list = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], (*path, str(k)))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, (*path, str(i)))
        else:
            out.append((sep.join(path), node))

    walk(tree, ())
    return out


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_keys(tree)]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in flattening order."""
    it, end = iter(leaves), object()

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    out = build(like)
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree holds")
    return out
