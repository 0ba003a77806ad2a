"""Nested dicts and lists of tensors (parameter, gradient and optimizer
trees), visited in the reference's flatten order: dict keys sorted, lists
in order, the order of ``jax.tree_util`` and of ``bridge.leaf_names``."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List

import torch


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves: Iterable[Any]) -> Any:
    """A tree shaped like ``tree`` holding ``leaves`` (in flatten order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, *rest: Any, path: str = "") -> Any:
    """``fn(name, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, keeping the nesting; ``name`` is the leaf's ``keystr`` name
    (``"['layers'][0]['attn']['wq']"``), as ``bridge.leaf_names`` gives it."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, *(r[i] for r in rest), path=f"{path}[{i}]")
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)
