"""Plain-torch oracles for the attention kernels (PyTorch port).

Twins of the reference package's ``kernels/ref.py``:

* ``attention_naive`` / ``decode_attention_naive`` — the simplest
  semantics (materialise the S x T scores).  These define correctness.
* ``attention_blockwise`` — online softmax over (block_q, block_k) tiles,
  never materialising S x T; the model plane's ``ref`` path.

Rounding follows the reference: scores are taken in the inputs' dtype and
then widened to float32, probabilities are cast back to v's dtype before
the second product.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B,H,S,D) x (B,KV,T,D)^2 -> (B,H,S,D), GQA by head-group broadcast."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError("query heads must be a multiple of kv heads")
    scale = D ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(H // KV, dim=1)
    vr = v.repeat_interleave(H // KV, dim=1)
    logits = torch.einsum("bhsd,bhtd->bhst", q * scale, kr).float()
    if causal:
        # query i sits at absolute position (T - S) + i and sees keys <= it
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        logits = torch.where(kpos <= qpos, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bhsd", p, vr)


def _pick(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= ``target``."""
    d = min(target, n)
    while n % d:
        d -= 1
    return d


def attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        block_q: int = 512,
                        block_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention in plain torch (never materialises S x T).

    Block sizes shrink to divisors of S and T, so ragged lengths work.
    """
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scale_ = D ** -0.5 if scale is None else scale
    block_q = _pick(S, block_q)
    block_k = _pick(T, block_k)
    nq, nk = S // block_q, T // block_k
    offs = T - S
    dev = q.device
    outs = []
    for qi in range(nq):
        qchunk = q[:, :, qi * block_q:(qi + 1) * block_q] * scale_
        acc = torch.zeros((B, H, block_q, D), dtype=torch.float32, device=dev)
        m = torch.full((B, H, block_q), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, block_q), dtype=torch.float32, device=dev)
        # skip kv blocks that lie wholly above the diagonal for this q block
        hi = min(((qi + 1) * block_q + offs + block_k - 1) // block_k, nk) \
            if causal else nk
        for ki in range(hi):
            kk = k[:, :, ki * block_k:(ki + 1) * block_k].repeat_interleave(G, dim=1)
            vv = v[:, :, ki * block_k:(ki + 1) * block_k].repeat_interleave(G, dim=1)
            s = torch.einsum("bhqd,bhkd->bhqk", qchunk, kk).float()
            if causal:
                qpos = qi * block_q + torch.arange(block_q, device=dev)[:, None] + offs
                kpos = ki * block_k + torch.arange(block_k, device=dev)[None, :]
                s = torch.where(kpos <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(vv.dtype), vv).float()
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


def decode_attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           length: torch.Tensor,
                           scale: Optional[float] = None) -> torch.Tensor:
    """(B,H,D) query vs (B,KV,T,D) cache with per-batch valid ``length``."""
    B, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    scale_ = D ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(H // KV, dim=1)
    vr = v.repeat_interleave(H // KV, dim=1)
    logits = torch.einsum("bhd,bhtd->bht", q * scale_, kr).float()
    mask = torch.arange(T, device=q.device)[None, None, :] < length[:, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bht,bhtd->bhd", p, vr)
