"""Shared layers: init helpers, RMSNorm, RoPE, embeddings, LM head.

Plain functions on tensors, twins of the reference package's
``models/common.py``.  Initialisers draw from an explicit
``torch.Generator`` on the generator's device, with the reference's
distributions (the numbers differ: the two frameworks' generators differ).
Sharding constraints are not ported: the port runs on one device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, in_dim: int, out_shape: Sequence[int],
               dtype: torch.dtype) -> torch.Tensor:
    """Truncated-normal fan-in init for an (in_dim, *out) weight."""
    w = torch.empty((in_dim, *out_shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_init(cfg: ModelConfig, device: torch.device,
              d: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d = d if d is not None else cfg.d_model
    return {"scale": torch.ones(d, dtype=cfg.param_tdtype(), device=device)}


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """RMSNorm in float32, cast back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
    return (y * p["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (split-half, NeoX style, in float32)
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, x.device)
    ang = positions[..., None].float() * freqs  # (B,S,D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_for(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B,S) position ids from the batch, default 0..S-1."""
    if "positions" in batch:
        return batch["positions"]
    tokens = batch["tokens"]
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(B, S)


# ---------------------------------------------------------------------------
# embeddings + LM head
# ---------------------------------------------------------------------------
def embedding_init(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    return {"tok": embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.param_tdtype())}


def embed_tokens(cfg: ModelConfig, emb: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
    # index first, then cast: bit-identical to the reference's cast-then-index
    # without a full-table cast per step
    return emb["tok"][tokens].to(cfg.compute_tdtype())


def lm_head_logits(cfg: ModelConfig, emb: Dict[str, torch.Tensor],
                   out_w: Optional[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """float32 logits over the padded vocab; padded rows masked to -1e30.
    ``out_w`` is the untied head (tied embeddings are not ported yet)."""
    logits = h.float() @ out_w.float().t()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _xent_chunk(cfg: ModelConfig, hh: torch.Tensor, wf: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked next-token loss summed over one (B, C) chunk."""
    logits = hh.float() @ wf.t()  # (B,C,V) float32
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)  # (B,C)
    lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - lab) * mask).sum()


def chunked_softmax_xent(cfg: ModelConfig, emb: Dict[str, torch.Tensor],
                         out_w: Optional[torch.Tensor], h: torch.Tensor,
                         labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token loss without keeping (B,S,V) logits.

    Each chunk of ``min(cfg.loss_chunk, S)`` positions computes its (B,C,V)
    fp32 logits, their log-sum-exp and the label logit under
    ``torch.utils.checkpoint``, so that autograd keeps one chunk's logits at
    a time and recomputes them in the backward pass.
    """
    B, S, D = h.shape
    C = min(cfg.loss_chunk, S)
    if S % C:
        raise ValueError("seq len must divide loss_chunk")
    wf = out_w.float()  # the untied head (tied embeddings are not ported yet)
    mask = (torch.ones((B, S), dtype=torch.float32, device=h.device) if mask is None
            else mask.to(torch.float32))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, C):
        total = total + checkpoint(_xent_chunk, cfg, h[:, i:i + C], wf, labels[:, i:i + C],
                                   mask[:, i:i + C], use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def act_fn(name: str):
    if name in ("silu", "swiglu"):
        return F.silu
    raise NotImplementedError(f"activation {name!r} is not ported yet")
