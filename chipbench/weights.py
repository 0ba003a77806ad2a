"""Seeded weights, made by the benchmark on the device, in the layout of the
program's parameter tree.

The tree's leaves (their paths, shapes and dtypes) come from the program's
``init`` traced on the meta device, which allocates nothing; their values
come from one ``torch.Generator`` on the card, seeded by ``--seed``, one
draw a leaf in the tree's order: the same seed gives the same weights, and
the reference reads the very tensors the program is handed.  The scales
(fan-in, the embedding's 0.02, norms at one) are the reference's
(:func:`chipbench.reference.moe_lm.init_scale`).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

import torch

Path = Tuple[Any, ...]


def leaves(tree: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def rebuild(tree: Any, fn: Callable[[Path, Any], Any], path: Path = ()) -> Any:
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [rebuild(v, fn, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def seed_generator(seed: int, device: torch.device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` for one stream of draws of ``seed`` (any
    whole number up to 2**63 - 1: each stream's seed is mixed into 64 bits)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def param_shapes(model) -> Any:
    """The program's parameter tree on the meta device (shapes, dtypes)."""
    with torch.device("meta"):
        return model.init(torch.Generator())


def make_params(model, seed: int, device: torch.device, init_scale) -> Any:
    """The program's parameter tree filled with seeded draws on ``device``:
    a normal draw scaled by ``init_scale(path, shape)``, or ones where it
    returns None (norm scales).  A float32 leaf (the router) holds values
    that bf16 represents exactly, so that a program that rounds it to its
    compute dtype reads the same router the reference does."""
    gen = seed_generator(seed, device, stream=1)

    def fill(path, meta):
        scale = init_scale(path, tuple(meta.shape))
        if scale is None:
            return torch.ones(meta.shape, dtype=meta.dtype, device=device)
        t = torch.randn(meta.shape, dtype=meta.dtype, device=device, generator=gen).mul_(scale)
        return t.to(torch.bfloat16).to(meta.dtype) if meta.dtype == torch.float32 else t

    return rebuild(param_shapes(model), fill)


def clone_tree(tree: Any) -> Any:
    return rebuild(tree, lambda _, t: t.clone())
