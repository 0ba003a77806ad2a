"""RWKV6 (Finch) chunked WKV scan: the CUDA kernel's wrapper and its plain version.

The port of the TPU kernel ``rwkv6_scan`` (reference package,
``kernels/rwkv6_scan.py``).  The kernel is ``csrc/rwkv6_scan.cu``: one CTA
per (head, batch) loops over chunks of 32 positions.  For bf16 r/k/v it
stages each chunk with ``cp.async``, forms the pair matrix inside diagonal
sub-blocks of 8 positions by a decay walk (one factor exp(w) a row) and
about a sub-block boundary elsewhere, and runs the chunk products on the
tensor cores with operands split into bf16 parts, the fp32 state kept in
registers; fp32 r/k/v take a scalar fp32 kernel.
:func:`rwkv6_plain` is the same function in plain torch (the chunked
reference).

:func:`rwkv6_scan` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, ref

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

# the kernels' chunk and the bf16 kernel's diagonal sub-blocks of the pair
# matrix, in positions (``L`` and ``SUB`` of csrc/rwkv6_scan.cu)
CHUNK = 32
SUB = 8
# the reference's chunk, at which the plain version (and so the backward)
# runs; S must be a multiple of it or shorter
REF_CHUNK = 64

_HEAD_DIMS = (16, 32, 64)
_DTYPES = (torch.bfloat16, torch.float32)
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# r, k, v, w, u, s0, y, sfin, is_bf16, B, S, H, K, V, 12 strides, stream
_ARGTYPES = [*([_P] * 8), *([_I] * 6), *([_L] * 12), _P]


def rwkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor,
                s0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain torch: the chunked reference at
    the reference's chunk, ``min(REF_CHUNK, S)`` (S must be a multiple of it)."""
    return ref.rwkv6_scan_chunked(r, k, v, w, u, s0, chunk=min(REF_CHUNK, r.shape[1]))


def _check(r, k, v, w, u, s0) -> None:
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape or v.dim() != 4:
        raise ValueError(f"expected r = k = w (B,S,H,K), v (B,S,H,V); got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(w.shape)}, {tuple(v.shape)}")
    Bsz, S, H, K = r.shape
    V = v.shape[3]
    if v.shape[:3] != r.shape[:3]:
        raise ValueError("v disagrees with r on batch, sequence or heads")
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u must be (H,K) = {(H, K)}, got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (Bsz, H, K, V):
        raise ValueError(f"s0 must be (B,H,K,V) = {(Bsz, H, K, V)}, got {tuple(s0.shape)}")
    if not (r.dtype == k.dtype == v.dtype):
        raise TypeError("r, k and v must share a dtype")


def _check_cuda(r, k, v, w, u, s0) -> None:
    ts = [r, k, v, w, u] + ([s0] if s0 is not None else [])
    if not all(t.device == r.device for t in ts):
        raise ValueError("r, k, v, w, u and s0 must be on one device")
    if r.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bfloat16 or float32 r/k/v, not {r.dtype}")
    if any(t.dtype != torch.float32 for t in ts[3:]):
        raise TypeError("w, u and s0 must be float32")
    Bsz, S, H, K = r.shape
    V = v.shape[3]
    if K != V or K not in _HEAD_DIMS:
        raise ValueError(f"kernel takes K == V in {_HEAD_DIMS}, not K={K}, V={V}")
    if min(Bsz, S, H) == 0 or max(Bsz, H) > 65535:
        raise ValueError("empty batch, sequence or heads, or batch/heads > 65535 (grid limit)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        # the backward is ops' autograd.Function, whose forward calls this
        # wrapper with grad mode off
        raise NotImplementedError("the kernel has no backward of its own: "
                                  "differentiate through repro_torch.kernels.ops")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous (stride 1)")
    if not u.is_contiguous() or (s0 is not None and not s0.is_contiguous()):
        raise ValueError("u and s0 must be contiguous")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor,
               s0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k (B,S,H,K), v (B,S,H,V), w (B,S,H,K) fp32 log-decay <= 0, u (H,K)
    fp32, s0 (B,H,K,V) fp32 or None -> (y (B,S,H,V) in v's dtype, S_final fp32).

    Any S on the card (a ragged last chunk is masked); inputs may be
    strided views with a contiguous last dim.
    """
    global launches
    _check(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"no kernel for device {r.device}")
    _check_cuda(r, k, v, w, u, s0)
    Bsz, S, H, K = r.shape
    V = v.shape[3]
    y = torch.empty((Bsz, S, H, V), dtype=v.dtype, device=v.device)
    sfin = torch.empty((Bsz, H, K, V), dtype=torch.float32, device=v.device)
    fn = build.function("rwkv6_scan", "rwkv6_scan", _ARGTYPES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
             None if s0 is None else s0.data_ptr(), y.data_ptr(), sfin.data_ptr(),
             int(r.dtype == torch.bfloat16), Bsz, S, H, K, V,
             *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3], stream)
    if err:
        raise RuntimeError(f"rwkv6_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, sfin
