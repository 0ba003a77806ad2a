"""Flash attention forward: the CUDA kernel's wrapper and its plain version.

The port of the TPU kernel ``flash_attention_fwd`` (reference package,
``kernels/flash_attention.py``).  The kernel is ``csrc/flash_attention.cu``
(hand-written for Hopper, bf16 on the tensor cores, fp32 on the CUDA
cores); :func:`attention_plain` is the same function in plain torch.

:func:`flash_attention_fwd` takes the plain version only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_HEAD_DIMS = (64, 128, 192, 256)
_DTYPES = (torch.bfloat16, torch.float32)
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# q, k, v, o, is_bf16, B, H, KV, S, T, D, causal, scale, 12 strides, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             *([_L] * 12), _P]


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
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: head_dim must be contiguous (stride 1)")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides and base must be 16-byte aligned")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """(B,H,S,D) x (B,KV,T,D)^2 -> (B,H,S,D) in q's dtype.

    Causal rows sit at offset T - S; ragged S and T are masked, not
    refused.  Inputs may be strided views (e.g. a transposed (B,S,H,D)
    activation); only head_dim must be contiguous.
    """
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda(q, k, v)
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    scale_ = D ** -0.5 if scale is None else scale
    # keeps q's layout when q is a dense permuted view, so the caller's
    # transpose back to (B,S,H,D) costs no copy
    out = torch.empty_like(q)
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), B, H, KV, S, T, D, int(causal), scale_,
             *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
             stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    return out
