"""Flash attention: the CUDA kernels' wrappers and their plain versions.

The forward is the port of the TPU kernel ``flash_attention_fwd``
(reference package, ``kernels/flash_attention.py``).  The kernel is
``csrc/flash_attention.cu`` (hand-written for Hopper, on the tensor cores:
bf16 through wgmma, fp32 through mma.sync on three tf32 products of operand
splits); :func:`attention_plain` is the same function in plain torch.

The backward (:func:`flash_attention_bwd`, bf16 at head_dim 64 and 128)
replaces no TPU kernel: two kernels in the same file recompute the
probabilities from the log-sum-exp the forward writes with ``with_lse``;
:func:`flash_attention_bwd_plain` is their arithmetic in plain torch.

Each wrapper takes the plain version only for tensors on the CPU.  For
CUDA tensors it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, ref

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)
launches_bwd = 0  # the backward's launches, two a call, counted the same way

_HEAD_DIMS = (64, 128, 192, 256)
BWD_HEAD_DIMS = (64, 128)  # the backward kernels' and the forward's with the LSE
_DTYPES = (torch.bfloat16, torch.float32)
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# q, k, v, o, is_bf16, B, H, KV, S, T, D, causal, scale, 12 strides, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             *([_L] * 12), _P]
# q, k, v, o, lse, B, H, KV, S, T, D, causal, scale, 12 strides, stream
_LSE_ARGTYPES = [_P] * 5 + [_I] * 7 + [ctypes.c_float, *([_L] * 12), _P]
# q, k, v, lse, do, dq, dk, dv, delta, B, H, KV, S, T, D, causal, scale,
# 21 strides, stream
_BWD_ARGTYPES = [_P] * 9 + [_I] * 7 + [ctypes.c_float, *([_L] * 21), _P]


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """What the kernel computes, in plain torch: the blockwise online
    softmax of ``ref.attention_blockwise``, with the kernel's rule that a
    query row seeing no key (causal, S > T) returns zeros."""
    out = ref.attention_blockwise(q, k, v, causal, scale)
    S, T = q.shape[2], k.shape[2]
    if causal and S > T:
        out[:, :, :S - T] = 0
    return out


def _visible(S: int, T: int, causal: bool, device) -> Optional[torch.Tensor]:
    """(S, T) mask of the keys each query row sees (causal at offset T - S);
    None when every row sees every key."""
    if not causal:
        return None
    return (torch.arange(T, device=device)[None, :]
            <= torch.arange(S, device=device)[:, None] + (T - S))


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """What the forward writes with ``with_lse``, in plain torch: each query
    row's log-sum-exp of its scaled scores, (B,H,S) fp32; +inf for a row
    that sees no key (causal, S > T)."""
    B, H, S, D = q.shape
    scale_ = D ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(H // k.shape[1], dim=1)
    s = (q.float() @ kr.float().transpose(-1, -2)) * scale_
    vis = _visible(S, k.shape[2], causal, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    return lse.masked_fill(lse == -math.inf, math.inf)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                              scale: Optional[float] = None):
    """What the backward kernels compute, in plain torch: P = exp(scale S -
    LSE) from the forward's ``lse``, dP = dO V^T, delta = rowsum(P o dP),
    dS = P o (dP - delta), then dQ = scale dS K, dK = scale dS^T Q and dV =
    P^T dO, the query heads of a KV head summed.  Scores and sums are fp32;
    P and dS are rounded to v's and q's dtype as the products' operands.  A
    row with LSE +inf (it sees no key) gets zero gradients."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scale_ = D ** -0.5 if scale is None else scale
    qf, dof = q.float(), do.float()
    kr = k.repeat_interleave(G, dim=1).float()
    vr = v.repeat_interleave(G, dim=1).float()
    s = (qf @ kr.transpose(-1, -2)) * scale_
    vis = _visible(S, T, causal, q.device)
    if vis is not None:
        s = s.masked_fill(~vis, -math.inf)
    p = torch.exp(s - lse.float()[..., None])
    dp = dof @ vr.transpose(-1, -2)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    p, ds = p.to(v.dtype).float(), ds.to(q.dtype).float()
    dq = scale_ * (ds @ kr)
    dk = scale_ * (ds.transpose(-1, -2) @ qf).view(B, KV, G, T, D).sum(2)
    dv = (p.transpose(-1, -2) @ dof).view(B, KV, G, T, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,S,D), k = v (B,KV,T,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if H % k.shape[1]:
        raise ValueError("query heads must be a multiple of kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share a dtype")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be on one device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bfloat16 or float32, not {q.dtype}")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, not {q.shape[3]}")
    if min(q.shape[:3]) == 0 or min(k.shape[1:3]) == 0:
        raise ValueError("empty batch, heads or sequence")
    if max(q.shape[0], q.shape[1]) > 65535:
        raise ValueError("batch and heads must be <= 65535 (grid limit)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # the backward is ops' autograd.Function, whose forward calls this
        # wrapper with grad mode off
        raise NotImplementedError("the kernel has no backward of its own: "
                                  "differentiate through repro_torch.kernels.ops")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_layout(name, t)


def fits_kernel(t: torch.Tensor) -> bool:
    """Whether the kernels take ``t``'s layout: head_dim contiguous, the
    other strides and the base 16-byte aligned."""
    vec = 16 // t.element_size()
    return t.stride(3) == 1 and not any(s % vec for s in t.stride()[:3]) \
        and t.data_ptr() % 16 == 0


def _check_layout(name: str, t: torch.Tensor) -> None:
    if t.stride(3) != 1:
        raise ValueError(f"{name}: head_dim must be contiguous (stride 1)")
    if not fits_kernel(t):
        raise ValueError(f"{name}: strides and base must be 16-byte aligned")


def _check_bwd(q: torch.Tensor) -> None:
    if q.dtype != torch.bfloat16 or q.shape[3] not in BWD_HEAD_DIMS:
        raise ValueError(f"the kernels with the LSE take bfloat16 at head_dim in "
                         f"{BWD_HEAD_DIMS}, not {q.dtype} at {q.shape[3]}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        with_lse: bool = False):
    """(B,H,S,D) x (B,KV,T,D)^2 -> (B,H,S,D) in q's dtype; with
    ``with_lse`` also each row's log-sum-exp for :func:`flash_attention_bwd`
    ((B,H,S) fp32, bf16 at head_dim 64 or 128 only), as ``(out, lse)``.

    Causal rows sit at offset T - S; ragged S and T are masked, not
    refused.  Inputs may be strided views (e.g. a transposed (B,S,H,D)
    activation); only head_dim must be contiguous.
    """
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        out = attention_plain(q, k, v, causal, scale)
        return (out, attention_lse_plain(q, k, causal, scale)) if with_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda(q, k, v)
    if with_lse:
        _check_bwd(q)
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    scale_ = D ** -0.5 if scale is None else scale
    # keeps q's layout when q is a dense permuted view, so the caller's
    # transpose back to (B,S,H,D) costs no copy
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    if with_lse:
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        fn = build.function("flash_attention", "flash_attention_fwd_lse", _LSE_ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                 B, H, KV, S, T, D, int(causal), scale_, *strides, stream)
    else:
        fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 int(q.dtype == torch.bfloat16), B, H, KV, S, T, D, int(causal), scale_,
                 *strides, stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of attention at (q, k, v) against the output gradient
    ``do``, from the forward's ``lse`` (``with_lse``), in the inputs'
    layouts.  Deterministic: no atomics, the same bits from run to run.  On
    the card bf16 at head_dim 64 or 128; ``do`` as strided as q may be."""
    global launches_bwd
    _check(q, k, v)
    if do.shape != q.shape or lse.shape != q.shape[:3]:
        raise ValueError(f"do must have q's shape {tuple(q.shape)} and lse its first three; "
                         f"got {tuple(do.shape)}, {tuple(lse.shape)}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, lse, do, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda(q, k, v)
    _check_bwd(q)
    if not (do.device == lse.device == q.device):
        raise ValueError("lse and do must be on q's device")
    if do.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError("do must have q's dtype, lse float32")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    _check_layout("do", do)
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    scale_ = D ** -0.5 if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = build.function("flash_attention", "flash_attention_bwd", _BWD_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
             B, H, KV, S, T, D, int(causal), scale_,
             *(s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]), stream)
    if err:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    launches_bwd += 2
    return dq, dk, dv
