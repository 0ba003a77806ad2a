"""Front door for the attention kernels, with implementation selection.

``impl``:

* ``"ref"``   — the memory-efficient plain-torch twin (blockwise online
  softmax for attention; the naive oracle for decode, as in the reference)
* ``"cuda"``  — the hand-written Hopper kernel; on CPU tensors its wrapper
  runs the kernel's plain version
* ``"auto"``  — ``cuda`` for tensors on the card, ``ref`` elsewhere
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import ref


def _resolve(impl: str, x: torch.Tensor) -> str:
    if impl == "auto":
        return "cuda" if x.is_cuda else "ref"
    return impl


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """(B,H,S,D) x (B,KV,T,D)^2 -> (B,H,S,D); GQA via head groups."""
    impl = _resolve(impl, q)
    if impl == "ref":
        return ref.attention_blockwise(q, k, v, causal, scale)
    if impl == "cuda":
        return _flash.flash_attention_fwd(q, k, v, causal, scale)
    raise ValueError(f"unknown impl {impl!r}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, scale: Optional[float] = None,
                     impl: str = "auto") -> torch.Tensor:
    """(B,H,D) query vs (B,KV,T,D) cache with per-batch valid lengths."""
    impl = _resolve(impl, q)
    if impl == "ref":
        return ref.decode_attention_naive(q, k, v, length, scale)
    if impl == "cuda":
        return _decode.flash_decode(q, k, v, length, scale)
    raise ValueError(f"unknown impl {impl!r}")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {"flash_attention_fwd": _flash.launches, "flash_decode": _decode.launches}


def reset_launch_counts() -> None:
    _flash.launches = 0
    _decode.launches = 0
