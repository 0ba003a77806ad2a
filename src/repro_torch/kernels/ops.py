"""Front door for every kernel, with implementation selection.

``impl``:

* ``"ref"``   — the memory-efficient plain-torch twin (blockwise online
  softmax for attention; the naive oracle for decode, as in the reference;
  the chunked scans at the reference's chunk lengths)
* ``"cuda"``  — the hand-written Hopper kernel; on CPU tensors its wrapper
  runs the kernel's plain version
* ``"auto"``  — ``cuda`` for tensors on the card, ``ref`` elsewhere

``cuda`` runs attention and the two scans through ``torch.autograd.Function``s,
the twins of the reference's ``jax.custom_vjp`` wrappers: the forward is the
kernel's wrapper and saves only the inputs; the backward recomputes the
plain twin (``ref.attention_blockwise``; ``mamba2_plain`` and
``rwkv6_plain``, the chunked scans at the reference's chunks) under
autograd and returns its gradients.  There is no
hand-written backward kernel, as in the reference.  The chunked backward
needs S to be a multiple of the chunk, so with grad enabled the scans
refuse any other S when called, not in the backward pass.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

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


def _vjp(name: str, plain: Callable, saved: Sequence[Optional[torch.Tensor]],
         needs: Sequence[bool], grads: Sequence[torch.Tensor]) -> tuple:
    """Gradients of ``plain`` at ``saved`` against the output gradients
    ``grads``, by autograd through ``plain``; None where ``needs`` is false
    or the input was None.  Callers pass ``ctx.saved_tensors`` read once:
    under a checkpoint its unpack hooks refuse a second read."""
    with torch.profiler.record_function(f"plain backward: {name}"), torch.enable_grad():
        xs = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(saved, needs)]
        wrt = [x for x in xs if x is not None and x.requires_grad]
        outs = plain(*xs)
        got = iter(torch.autograd.grad(outs if isinstance(outs, tuple) else (outs,),
                                       wrt, grads))
    return tuple(next(got) if x is not None and x.requires_grad else None for x in xs)


def _refuse_ragged(S: int, chunk: int, *ts: Optional[torch.Tensor]) -> None:
    """The chunked backward's rule (S a multiple of min(chunk, S)), checked
    in the forward pass when a gradient will be asked for."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts) \
            and S % min(chunk, S):
        raise ValueError("S must divide chunk")


class _AttentionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _flash.flash_attention_fwd(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        def plain(q, k, v):
            return ref.attention_blockwise(q, k, v, ctx.causal, ctx.scale)
        return (*_vjp("attention", plain, ctx.saved_tensors, ctx.needs_input_grad[:3], (g,)),
                None, None)


class _Mamba2Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, h0):
        ctx.save_for_backward(x, dt, A, Bm, Cm, h0)
        return _mamba2.mamba2_scan(x, dt, A, Bm, Cm, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        return _vjp("mamba2", _mamba2.mamba2_plain, ctx.saved_tensors, ctx.needs_input_grad,
                    (gy, gh))


class _RWKV6Fn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0):
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _rwkv6.rwkv6_scan(r, k, v, w, u, s0)

    @staticmethod
    def backward(ctx, gy, gs):
        return _vjp("rwkv6", _rwkv6.rwkv6_plain, ctx.saved_tensors, ctx.needs_input_grad,
                    (gy, gs))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: Optional[float] = None,
              impl: str = "auto") -> torch.Tensor:
    """(B,H,S,D) x (B,KV,T,D)^2 -> (B,H,S,D); GQA via head groups."""
    impl = _resolve(impl, q)
    if impl == "ref":
        return ref.attention_blockwise(q, k, v, causal, scale)
    if impl == "cuda":
        return _AttentionFn.apply(q, k, v, causal, scale)
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
        _refuse_ragged(x.shape[1], _mamba2.REF_CHUNK, x, dt, A, B, C, h0)
        return _Mamba2Fn.apply(x, dt, A, B, C, h0)
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
        _refuse_ragged(r.shape[1], _rwkv6.REF_CHUNK, r, k, v, w, u, s0)
        return _RWKV6Fn.apply(r, k, v, w, u, s0)
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
