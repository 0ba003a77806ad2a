"""GQA/MQA attention block with RoPE or M-RoPE and optional qkv biases,
twin of the reference's ``attn_*``.

Activations are (B,S,H,hd); the kernels take (B,H,S,hd), which here is a
transposed view, not a copy.  The KV cache is stored (B,T,KV,hd) as in the
reference and handed to decode attention as a transposed view too.

The reference updates its cache functionally (``dynamic_update_slice``);
the port writes the cache in place and returns the same dict.  Positions
must lie inside the cache (``pos < max_len``), which the generate loop
guarantees; out-of-range writes raise instead of being clamped.

MLA is not ported yet (``config.check_supported`` refuses it).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from .common import apply_mrope, apply_rope, dense_init
from .config import ModelConfig

Tensors = Dict[str, torch.Tensor]


def attn_init(cfg: ModelConfig, gen: torch.Generator) -> Tensors:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.param_tdtype()
    p = {
        "wq": dense_init(gen, D, (H, hd), dt),
        "wk": dense_init(gen, D, (KV, hd), dt),
        "wv": dense_init(gen, D, (KV, hd), dt),
        "wo": dense_init(gen, H * hd, (D,), dt).reshape(H, hd, D),
    }
    if cfg.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((KV, hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((KV, hd), dtype=dt, device=dev)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    D, H, hd = w.shape
    return (x @ w.to(x.dtype).reshape(D, H * hd)).unflatten(-1, (H, hd))


def _qkv(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
         positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """positions: (B, S), or (3, B, S) for M-RoPE."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.rope_type == "mrope":
        q = apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    elif cfg.rope_type == "standard":  # "none": no position encoding
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matrix product; o is (B,S,H,hd)."""
    H, hd, D = wo.shape
    return o.reshape(*o.shape[:2], H * hd) @ wo.to(o.dtype).reshape(H * hd, D)


def attn_apply(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D), full-sequence causal attention."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, impl=cfg.attn_impl)
    return _out(o.transpose(1, 2), p["wo"])


def attn_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype: torch.dtype, device: torch.device) -> Tensors:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_prefill(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                 positions: torch.Tensor,
                 cache: Tensors) -> Tuple[torch.Tensor, Tensors]:
    """Prompt of S tokens: write cache[:, :S] in place, attend causally."""
    q, k, v = _qkv(cfg, p, x, positions)
    S = x.shape[1]
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=True, impl=cfg.attn_impl)
    return _out(o.transpose(1, 2), p["wo"]), cache


def attn_decode(cfg: ModelConfig, p: Tensors, x: torch.Tensor, pos: torch.Tensor,
                cache: Tensors) -> Tuple[torch.Tensor, Tensors]:
    """x: (B,1,D); pos: (B,) int32 current position; in-cache attention."""
    B = x.shape[0]
    positions = pos[None, :, None].expand(3, B, 1) if cfg.rope_type == "mrope" else pos[:, None]
    q, k, v = _qkv(cfg, p, x, positions)
    rows = torch.arange(B, device=x.device)
    idx = pos.long()
    cache["k"][rows, idx] = k[:, 0]
    cache["v"][rows, idx] = v[:, 0]
    o = ops.decode_attention(q[:, 0], cache["k"].transpose(1, 2),
                             cache["v"].transpose(1, 2), pos + 1,
                             impl=cfg.attn_impl)
    return _out(o[:, None], p["wo"]), cache
