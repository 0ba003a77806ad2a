"""Shared layers: init helpers, norms, RoPE / M-RoPE, embeddings, LM head.

Plain functions on tensors, twins of the reference package's
``models/common.py``.  Initialisers draw from an explicit
``torch.Generator`` on the generator's device, with the reference's
distributions (the numbers differ: the two frameworks' generators differ);
under ``with torch.device("meta")`` they make shapes only (``init_device``).
Sharding constraints are not ported: the port runs on one device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def init_device(gen: torch.Generator) -> torch.device:
    """Where an initialiser puts its tensor: the generator's device, or the
    meta device inside ``with torch.device("meta")``.  A draw from a CPU
    generator into a meta tensor allocates nothing and changes no value on
    another device, so a full-size tree's shapes and dtypes cost no memory
    (``torch.Generator`` refuses the meta device itself)."""
    default = torch.get_default_device()
    return default if default.type == "meta" else gen.device


def dense_init(gen: torch.Generator, in_dim: int, out_shape: Sequence[int],
               dtype: torch.dtype) -> torch.Tensor:
    """Truncated-normal fan-in init for an (in_dim, *out) weight.  Scaled in
    place: one fp32 copy of the weight at a time (5 GB for one of
    deepseek-v2's expert stacks)."""
    w = torch.empty((in_dim, *out_shape), dtype=torch.float32, device=init_device(gen))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=init_device(gen))
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_init(cfg: ModelConfig, device: torch.device,
              d: Optional[int] = None) -> Dict[str, torch.Tensor]:
    d = d if d is not None else cfg.d_model
    dt = cfg.param_tdtype()
    fill = torch.zeros if cfg.norm_unit_offset else torch.ones
    p = {"scale": fill(d, dtype=dt, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=dt, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    """LayerNorm (with bias) or RMSNorm in float32, cast back to x's dtype.
    With ``norm_unit_offset`` the stored scale is an offset from 1 (Gemma)."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).pow(2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
    scale = p["scale"].float()
    if cfg.norm_unit_offset:
        scale = scale + 1.0
    return (y * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE and M-RoPE (split-half, NeoX style, in float32)
# ---------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D) rotated by the (B, S, D/2) angles, split-half."""
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections: Tuple[int, int, int]) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.  ``positions``: (3, B, S) temporal, height
    and width ids (equal for text tokens); the rotary half-dim is split
    into three sections, each rotated by its own position stream."""
    D = x.shape[-1]
    if sum(sections) != D // 2:
        raise ValueError(f"mrope sections {sections} must sum to head_dim/2 = {D // 2}")
    pos = positions.float()
    # (B, S, D/2): the frequencies of section i read position stream i
    ang = torch.cat([pos[i, ..., None].expand(*pos.shape[1:], n)
                     for i, n in enumerate(sections)], dim=-1)
    return _rotate(x, ang * rope_freqs(D, theta, x.device))


def positions_for(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B,S) position ids, or (3,B,S) for M-RoPE, from the batch; default
    0..S-1 (on every stream)."""
    if "positions" in batch:
        return batch["positions"]
    tokens = batch["tokens"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    return pos[None].expand(3, B, S) if cfg.rope_type == "mrope" else pos


# ---------------------------------------------------------------------------
# embeddings + LM head
# ---------------------------------------------------------------------------
def embedding_init(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    return {"tok": embed_init(gen, cfg.padded_vocab, cfg.d_model, cfg.param_tdtype())}


def embed_tokens(cfg: ModelConfig, emb: Dict[str, torch.Tensor],
                 tokens: torch.Tensor) -> torch.Tensor:
    # index first, then cast: bit-identical to the reference's cast-then-index
    # without a full-table cast per step
    x = emb["tok"][tokens].to(cfg.compute_tdtype())
    if cfg.scale_embed:
        # the reference rounds sqrt(d_model) to x's dtype first (bf16:
        # sqrt(3072) = 55.43 becomes 55.5); the product of that scalar and
        # x, computed in fp32 and rounded once, is the reference's
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def merge_visual(cfg: ModelConfig, x: torch.Tensor,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Qwen2-VL stub: precomputed patch embeddings (B, n_img, D) take the
    first ``n_img`` token slots (the modality frontend is out of scope)."""
    if not cfg.visual_stub or "visual_embeds" not in batch:
        return x
    ve = batch["visual_embeds"].to(x.dtype)
    return torch.cat([ve, x[:, ve.shape[1]:]], dim=1)


def _head_weight(cfg: ModelConfig, emb: Dict[str, torch.Tensor],
                 out_w: Optional[torch.Tensor]) -> torch.Tensor:
    """The (V, D) head: the embedding table when tied."""
    return emb["tok"] if cfg.tie_embeddings or out_w is None else out_w


def _softcap(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def lm_head_logits(cfg: ModelConfig, emb: Dict[str, torch.Tensor],
                   out_w: Optional[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """float32 logits over the padded vocab, softcapped when configured;
    padded rows masked to -1e30.  ``out_w`` is the untied head, or None."""
    logits = _softcap(cfg, h.float() @ _head_weight(cfg, emb, out_w).float().t())
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _xent_chunk(cfg: ModelConfig, hh: torch.Tensor, wf: torch.Tensor,
                labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked next-token loss summed over one (B, C) chunk."""
    logits = _softcap(cfg, hh.float() @ wf.t())  # (B,C,V) float32
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
    wf = _head_weight(cfg, emb, out_w).float()
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
    if name in ("gelu", "geglu", "gelu_mlp"):  # the tanh GELU, as the reference's
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)
