"""Flash decode: the CUDA kernel's wrapper and its plain version.

The port of the TPU kernel ``flash_decode`` (reference package,
``kernels/decode_attention.py``).  The kernel is
``csrc/decode_attention.cu``: the valid cache ``[0, length[b])`` of each
(batch, kv head) pair is split over a cluster of :func:`split_count` CTAs,
whose partial softmax states are merged by log-sum-exp; each CTA serves
the H // KV query heads of the group.  :func:`decode_plain` is the same
function in plain torch.

:func:`flash_decode` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

_HEAD_DIMS = (64, 128, 256)
_DTYPES = (torch.bfloat16, torch.float32)
_MAX_GROUP_ELEMS = 256 * 8  # (H // KV) * D outputs held in one CTA's registers
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# q, k, v, length, o, is_bf16, B, H, KV, T, D, splits, scale, 10 strides, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             *([_L] * 10), _P]

# The kernel's partition of the cache axis (csrc/decode_attention.cu): a
# warp steps through CHUNK keys at a time, a CTA of WARPS warps through
# TILE keys, and the C CTAs of a (batch, kv head) pair form one cluster.
CHUNK, WARPS = 16, 4
TILE = CHUNK * WARPS
MAX_SPLITS = 8  # the portable cluster size
SMS = 132       # streaming multiprocessors of an H100 SXM


def split_count(B: int, KV: int, T: int) -> int:
    """CTAs per (batch, kv head) pair: about two CTAs per SM over the
    B * KV pairs (rounded down, so that many pairs take one CTA each), at
    most a cluster of 8 and at most the TILE-key tiles of a cache of
    length T.  Depends on shapes only: ``length`` lies on the card, and
    reading it would synchronise."""
    return max(1, min(MAX_SPLITS, 2 * SMS // max(1, B * KV), -(-T // TILE)))


def decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """What the kernel computes, in plain torch: ``ref.decode_attention_naive``
    with the kernel's rule that ``length[b] == 0`` returns zeros."""
    out = ref.decode_attention_naive(q, k, v, length, scale)
    return torch.where((length > 0)[:, None, None], out, torch.zeros_like(out))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,H,D), k = v (B,KV,T,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if H % k.shape[1]:
        raise ValueError("query heads must be a multiple of kv heads")
    if length.shape != (B,):
        raise ValueError(f"length must be (B,) = ({B},), got {tuple(length.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("q, k and v must share a dtype")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                length: torch.Tensor) -> None:
    if not all(t.device == q.device for t in (k, v, length)):
        raise ValueError("q, k, v and length must be on one device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bfloat16 or float32, not {q.dtype}")
    if length.dtype != torch.int32:
        raise TypeError(f"length must be int32, not {length.dtype}")
    B, H, D = q.shape
    KV = k.shape[1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, not {D}")
    if (H // KV) * D > _MAX_GROUP_ELEMS:
        raise ValueError(f"(H // KV) * D must be <= {_MAX_GROUP_ELEMS}")
    if min(B, H, k.shape[2]) == 0 or B * KV * MAX_SPLITS >= 2 ** 31:
        raise ValueError("empty batch, heads or cache, or batch x kv heads >= 2^28 "
                         "(grid limit)")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("the CUDA kernel has no backward yet")
    if q.stride(2) != 1:
        raise ValueError("q: head_dim must be contiguous (stride 1)")
    vec = 16 // q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: head_dim must be contiguous (stride 1)")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides and base must be 16-byte aligned")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """(B,H,D) query vs (B,KV,T,D) cache with per-batch valid ``length``
    (int32, on q's device) -> (B,H,D) in q's dtype.

    K/V may be strided views, such as the transposed (B,T,KV,D) cache.
    """
    global launches
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_plain(q, k, v, length, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_cuda(q, k, v, length)
    B, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    scale_ = D ** -0.5 if scale is None else scale
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    fn = build.function("decode_attention", "flash_decode", _ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), B, H, KV, T, D, split_count(B, KV, T), scale_,
             *q.stride()[:2], *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
             stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {err}")
    launches += 1
    return out
