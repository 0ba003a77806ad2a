"""Int8 gradient compression codec with error feedback (PyTorch port).

Twin of the reference's ``optim/compress.py``: before a slow reduction,
gradients are quantized to int8 with a per-tensor scale, and the
quantization residual is carried to the next step (error feedback), which
keeps the sum of what was sent equal to the sum of the gradients.

The arithmetic is the reference's, in fp32: ``scale = max(max|x|,
1e-12) / 127``, round half to even (``torch.round``, as ``jnp.round``),
clip to +-127, int8.  Without a generator the result equals the
reference's bit for bit.  With a ``torch.Generator`` the rounding is
stochastic, ``floor(y + u)`` with u uniform in [0, 1) drawn on x's device.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def quantize_int8(x: torch.Tensor, gen: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization -> (q int8, 0-d fp32 scale);
    stochastic rounding if a generator is given."""
    xf = x.float()
    # divided by a tensor on x's device: PyTorch's CUDA division multiplies
    # by the reciprocal of a Python scalar divisor, which can differ from
    # the quotient in the last bit
    scale = torch.clamp(xf.abs().max(), min=1e-12) / torch.full((), 127.0, device=xf.device)
    y = xf / scale
    if gen is not None:
        y = torch.floor(y + torch.rand(y.shape, generator=gen, device=y.device))
    else:
        y = torch.round(y)
    return torch.clamp(y, -127, 127).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def int8_codec_roundtrip(x: torch.Tensor, err: Optional[torch.Tensor] = None,
                         gen: Optional[torch.Generator] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize -> dequantize with error feedback: (x_hat, new_err) with
    x_hat + new_err == x + err (up to fp32)."""
    target = x.float() + (0.0 if err is None else err)  # the reference's: -0.0 becomes 0.0
    q, s = quantize_int8(target, gen)
    xhat = dequantize_int8(q, s)
    return xhat, target - xhat


def compress_grads(grads: Any, err_state: Optional[Any] = None) -> Tuple[Any, Any]:
    """The codec leaf by leaf over a nested dict/list gradient tree ->
    (x_hat tree, error tree), both fp32."""
    if err_state is None:
        err_state = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                   device=g.device), grads)
    out = [int8_codec_roundtrip(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err_state))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
