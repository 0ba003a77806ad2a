"""Front door for every kernel, with implementation selection.

``impl``:

* ``"ref"``   — the memory-efficient plain-torch twin (blockwise online
  softmax for attention; the naive oracle for decode, as in the reference;
  the chunked scans at the reference's chunk lengths)
* ``"cuda"``  — the hand-written Hopper kernel; on CPU tensors its wrapper
  runs the kernel's plain version
* ``"auto"``  — ``cuda`` for tensors on the card, ``ref`` elsewhere
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import mamba2_scan as _mamba2
from . import ref
from . import rwkv6_scan as _rwkv6

_KERNELS = {"flash_attention_fwd": _flash, "flash_decode": _decode,
            "mamba2_scan": _mamba2, "rwkv6_scan": _rwkv6}


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


def mamba2(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
           C: torch.Tensor, h0: Optional[torch.Tensor] = None,
           impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y, h_final)."""
    impl = _resolve(impl, x)
    if impl == "ref":
        return _mamba2.mamba2_plain(x, dt, A, B, C, h0)
    if impl == "cuda":
        return _mamba2.mamba2_scan(x, dt, A, B, C, h0)
    raise ValueError(f"unknown impl {impl!r}")


def mamba2_decode(x, dt, A, B, C, h):
    """Single-token SSD step (serving): plain torch, as in the reference."""
    return ref.mamba2_decode_step(x, dt, A, B, C, h)


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, s0: Optional[torch.Tensor] = None,
          impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6 scan -> (y, s_final)."""
    impl = _resolve(impl, r)
    if impl == "ref":
        return _rwkv6.rwkv6_plain(r, k, v, w, u, s0)
    if impl == "cuda":
        return _rwkv6.rwkv6_scan(r, k, v, w, u, s0)
    raise ValueError(f"unknown impl {impl!r}")


def rwkv6_decode(r, k, v, w, u, s):
    """Single-token WKV6 step (serving): plain torch, as in the reference."""
    return ref.rwkv6_decode_step(r, k, v, w, u, s)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
