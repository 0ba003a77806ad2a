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

Over a mesh the four front doors take DTensors (:func:`_on_shards`): each
kernel runs on the local shards, where its inputs are sharded only along
the batch (over the data axes) or the heads (over "model"); any other
placement is first redistributed to one of those or to replicated.  The
outputs are DTensors again, and the launch counts count the local launches.
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


#: (batch dim, head dim) of each input and output of the four front doors;
#: None where a tensor has no such dim.  A head dim of size 1 (MQA's single
#: KV head, Mamba2's single group) is shared by all the heads, so it stays
#: whole on every rank.
_ROLES = {
    "attention": (((0, 1), (0, 1), (0, 1)), ((0, 1),)),
    "decode_attention": (((0, 1), (0, 1), (0, 1), (0, None)), ((0, 1),)),
    "mamba2": (((0, 2), (0, 2), (None, 0), (0, 2), (0, 2), (0, 1)), ((0, 2), (0, 1))),
    "rwkv6": (((0, 2), (0, 2), (0, 2), (0, 2), (None, 0), (0, 1)), ((0, 2), (0, 1))),
}


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _on_shards(name: str, fn: Callable, tensors: Sequence[Optional[torch.Tensor]],
               **kw):
    """``fn`` (a front door) on the local shards of ``tensors``, at least one
    of them a DTensor; returns DTensors over the same mesh.

    Each mesh dim on which the first DTensor is sharded along its batch or
    head dim keeps that role, where every input's dim of that role divides
    (a head dim may also be 1); on every other mesh dim all inputs are
    replicated.  An input without a dim of the mesh dim's role is
    replicated there, and its gradient is a partial sum there.  Plain
    tensors count as replicated."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    in_roles, out_roles = _ROLES[name]
    i = next(i for i, t in enumerate(tensors) if _is_dtensor(t))
    lead, lead_roles = tensors[i], in_roles[i]
    mesh = lead.device_mesh
    plan, div = [], [1, 1]
    for m, n in enumerate(mesh.shape):
        pl, role = lead.placements[m], None
        if n > 1 and isinstance(pl, Shard) and pl.dim in lead_roles:
            role = lead_roles.index(pl.dim)
            d = div[role] * n
            if all(t is None or r[role] is None or t.shape[r[role]] % d == 0
                   or (role == 1 and t.shape[r[role]] == 1)
                   for t, r in zip(tensors, in_roles)):
                div[role] = d
            else:
                role = None
        plan.append(role)

    def local(t, roles):
        if t is None:
            return None
        if not _is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        want, grad = [], []
        for role in plan:
            dim = None if role is None else roles[role]
            if dim is not None and not (role == 1 and t.shape[dim] == 1):
                want.append(Shard(dim))
                grad.append(Shard(dim))
            else:
                want.append(Replicate())
                grad.append(Replicate() if role is None else Partial())
        return t.redistribute(mesh, want).to_local(grad_placements=grad)

    outs = fn(*(local(t, r) for t, r in zip(tensors, in_roles)), **kw)
    single = not isinstance(outs, tuple)

    def wrap(o, roles):
        pl = [Replicate() if role is None else Shard(roles[role]) for role in plan]
        return DTensor.from_local(o, mesh, pl, run_check=False)

    outs = tuple(wrap(o, r) for o, r in zip((outs,) if single else outs, out_roles))
    return outs[0] if single else outs


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
    if any(map(_is_dtensor, (q, k, v))):
        return _on_shards("attention", attention, (q, k, v), causal=causal, scale=scale,
                          impl=impl)
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
    if any(map(_is_dtensor, (q, k, v, length))):
        return _on_shards("decode_attention", decode_attention, (q, k, v, length),
                          scale=scale, impl=impl)
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
    if any(map(_is_dtensor, (x, dt, A, B, C, h0))):
        return _on_shards("mamba2", mamba2, (x, dt, A, B, C, h0), impl=impl)
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
    if any(map(_is_dtensor, (r, k, v, w, u, s0))):
        return _on_shards("rwkv6", rwkv6, (r, k, v, w, u, s0), impl=impl)
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
