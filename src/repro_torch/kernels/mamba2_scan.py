"""Mamba2 (SSD) chunked scan: the CUDA kernel's wrapper and its plain version.

The port of the TPU kernel ``mamba2_scan`` (reference package,
``kernels/mamba2_scan.py``).  The kernel is ``csrc/mamba2_scan.cu``: one
CTA per (head, batch) loops over chunks of 64 positions.  For bf16 x/B/C
it is one warpgroup that stages each chunk with ``cp.async`` and runs the
four chunk products on ``wgmma``, with W, the state and B scaled by its
decay each split into two bf16 parts, the fp32 state kept in registers;
fp32 x/B/C take a scalar fp32 kernel.  :func:`mamba2_plain` is the same
function in plain torch (the chunked reference).

:func:`mamba2_scan` takes the plain version only for tensors on the CPU.
For CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build, ref

launches = 0  # kernel launches since the last reset (ops.reset_launch_counts)

# the kernels' chunk, in positions (``L`` of csrc/mamba2_scan.cu)
CHUNK = 64
# the reference's chunk, at which the plain version (and so the backward)
# runs; S must be a multiple of it or shorter
REF_CHUNK = 128

_P_DIMS = (16, 32, 64)
_N_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.bfloat16, torch.float32)
_I, _L, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
# x, dt, A, B, C, h0, y, hfin, is_bf16, B, S, H, G, P, N, 12 strides, stream
_ARGTYPES = [*([_P] * 8), *([_I] * 7), *([_L] * 12), _P]


def mamba2_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain torch: the chunked reference at
    the reference's chunk, ``min(REF_CHUNK, S)`` (S must be a multiple of it)."""
    return ref.mamba2_scan_chunked(x, dt, A, Bm, Cm, h0, chunk=min(REF_CHUNK, x.shape[1]))


def _check(x, dt, A, Bm, Cm, h0) -> None:
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 4 or Cm.shape != Bm.shape:
        raise ValueError(f"expected x (B,S,H,P), dt (B,S,H), A (H,), B = C (B,S,G,N); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if tuple(dt.shape) != (Bsz, S, H) or tuple(A.shape) != (H,) or Bm.shape[:2] != x.shape[:2]:
        raise ValueError("x, dt, A, B and C disagree on batch, sequence or heads")
    if H % G:
        raise ValueError("H must be a multiple of G")
    if h0 is not None and tuple(h0.shape) != (Bsz, H, P, N):
        raise ValueError(f"h0 must be (B,H,P,N) = {(Bsz, H, P, N)}, got {tuple(h0.shape)}")
    if not (x.dtype == Bm.dtype == Cm.dtype):
        raise TypeError("x, B and C must share a dtype")


def _check_cuda(x, dt, A, Bm, Cm, h0) -> None:
    ts = [x, dt, A, Bm, Cm] + ([h0] if h0 is not None else [])
    if not all(t.device == x.device for t in ts):
        raise ValueError("x, dt, A, B, C and h0 must be on one device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bfloat16 or float32 x/B/C, not {x.dtype}")
    if any(t.dtype != torch.float32 for t in ts[1:3] + ts[5:]):
        raise TypeError("dt, A and h0 must be float32")
    Bsz, S, H, P = x.shape
    N = Bm.shape[3]
    if P not in _P_DIMS or N not in _N_DIMS:
        raise ValueError(f"kernel takes headdim P in {_P_DIMS} and d_state N in {_N_DIMS}, "
                         f"not {P}, {N}")
    if min(Bsz, S, H) == 0 or max(Bsz, H) > 65535:
        raise ValueError("empty batch, sequence or heads, or batch/heads > 65535 (grid limit)")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        # the backward is ops' autograd.Function, whose forward calls this
        # wrapper with grad mode off
        raise NotImplementedError("the kernel has no backward of its own: "
                                  "differentiate through repro_torch.kernels.ops")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the last dim must be contiguous (stride 1)")
    if not A.is_contiguous() or (h0 is not None and not h0.is_contiguous()):
        raise ValueError("A and h0 must be contiguous")


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32, B/C (B,S,G,N), h0
    (B,H,P,N) fp32 or None -> (y (B,S,H,P) in x's dtype, h_final fp32).

    Any S on the card (a ragged last chunk is masked); x, dt, B and C may
    be strided views such as the model's split of one projection.
    """
    global launches
    _check(x, dt, A, Bm, Cm, h0)
    if x.device.type == "cpu":
        return mamba2_plain(x, dt, A, Bm, Cm, h0)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_cuda(x, dt, A, Bm, Cm, h0)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    hfin = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    fn = build.function("mamba2_scan", "mamba2_scan", _ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(), hfin.data_ptr(),
             int(x.dtype == torch.bfloat16), Bsz, S, H, G, P, N,
             *x.stride()[:3], *dt.stride(), *Bm.stride()[:3], *Cm.stride()[:3], stream)
    if err:
        raise RuntimeError(f"mamba2_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, hfin
