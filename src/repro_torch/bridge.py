"""Carry parameter trees between the reference package and the port.

A reference tree, passed through numpy (``jax.tree.map(np.asarray,
params)``), is nested dicts and lists of numpy arrays; the port's tree has
the same nesting with tensors.  Leaf names are the ``jax.tree_util.keystr``
strings (``"['layers'][0]['attn']['wq']"``), produced here without JAX.

bfloat16: numpy has no bfloat16 of its own; the reference's arrays come as
``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses.  Such arrays
cross as their 16-bit patterns, so values are bit-identical both ways.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch

from repro_torch.tree import tree_map


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr, order="C", copy=True)  # owned and writable: JAX's are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # the bfloat16 numpy dtype exists once ml_dtypes is loaded (JAX loads it)
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError("numpy has no bfloat16 dtype registered; "
                            "import ml_dtypes (or jax) first") from e
        return t.view(torch.int16).numpy().view(np.uint16).view(bf16)
    return t.numpy()


def params_from_numpy(tree: Any, device) -> Any:
    """Nested dicts/lists of numpy arrays (a parameter tree or a whole train
    state, 0-d int32 ``step`` included) -> the same nesting of tensors on
    ``device``."""
    return tree_map(lambda a: _to_tensor(np.asarray(a), device), tree)


def params_to_numpy(params: Any) -> Any:
    """Nested dicts/lists of tensors -> the same nesting of numpy arrays."""
    return tree_map(_to_numpy, params)


def leaf_names(tree: Any, prefix: str = "") -> List[str]:
    """``keystr`` names of the leaves, in ``jax.tree_util`` flatten order
    (dict keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]
