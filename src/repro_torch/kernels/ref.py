"""Plain-torch oracles for the kernels (PyTorch port).

Twins of the reference package's ``kernels/ref.py``:

* ``attention_naive`` / ``decode_attention_naive`` — the simplest
  semantics (materialise the S x T scores).  These define correctness.
* ``attention_blockwise`` — online softmax over (block_q, block_k) tiles,
  never materialising S x T; the model plane's ``ref`` path.
* ``mamba2_scan_naive`` / ``rwkv6_scan_naive`` — token-by-token
  recurrences; ``*_scan_chunked`` — the chunked forms the kernels compute
  (the ``ref`` path); ``*_decode_step`` — one serving step.

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


# ---------------------------------------------------------------------------
# Mamba2 (SSD) scan
# ---------------------------------------------------------------------------
def mamba2_scan_naive(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                      Bm: torch.Tensor, Cm: torch.Tensor,
                      h0: Optional[torch.Tensor] = None):
    """Token-by-token SSD recurrence:
        h_t = exp(dt_t A) h_{t-1} + dt_t * x_t B_t^T ;  y_t = h_t C_t
    x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N), h0 (B,H,P,N).
    Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) float32)."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError("H must be a multiple of G")
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=2)  # (B,S,H,N)
    Ch = Cm.repeat_interleave(rep, dim=2)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])  # (B,H)
        # x * B in the inputs' dtype, as the reference rounds it
        upd = dt[:, t][..., None, None] * (x[:, t][..., :, None] * Bh[:, t][..., None, :])
        h = h * decay[..., None, None] + upd.float()
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h


def mamba2_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bm: torch.Tensor, Cm: torch.Tensor,
                        h0: Optional[torch.Tensor] = None, chunk: int = 128):
    """Chunked SSD: dense intra-chunk products + inter-chunk state carry,
    the plain twin of the kernel.  Equal to the naive recurrence up to
    rounding (fp32 accumulation).  ``S`` must be a multiple of ``chunk``."""
    B, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if S % chunk:
        raise ValueError("S must divide chunk")
    nc = S // chunk
    Bh = Bm.repeat_interleave(rep, dim=2).reshape(B, nc, chunk, H, N)
    Ch = Cm.repeat_interleave(rep, dim=2).reshape(B, nc, chunk, H, N)
    xc = x.reshape(B, nc, chunk, H, P)
    dtc = dt.reshape(B, nc, chunk, H)
    # per-chunk cumulative log-decay: a_t = dt_t * A  (<= 0)
    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)  # inclusive over L
    # (1,t,s,1): pairs s <= t; the exponent is masked, not the exp
    lmask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))[None, :, :, None]
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for i in range(nc):
        cs = cum[:, i]        # (B,L,H) inclusive
        xb, bb, cb, dtb = xc[:, i], Bh[:, i], Ch[:, i], dtc[:, i]
        total = cs[:, -1]     # (B,H) full-chunk log decay
        # y_intra[t] = sum_{s<=t} exp(cs_t - cs_s) dt_s (C_t.B_s) x_s
        expo = torch.where(lmask, cs[:, :, None, :] - cs[:, None, :, :], NEG_INF)
        cb_dot_bb = torch.einsum("blhn,bmhn->blmh", cb, bb)  # inputs' dtype, as the reference
        w = torch.exp(expo) * cb_dot_bb * dtb[:, None, :, :]  # (B,t,s,H) float32
        y_intra = torch.einsum("blmh,bmhp->blhp", w, xb.float())
        # carried-in state: y_state[t] = C_t . (exp(cs_t) h)
        y_state = torch.einsum("blhn,bhpn->blhp", cb.float(), h) * torch.exp(cs)[..., None]
        # h' = exp(total) h + sum_s exp(total - cs_s) dt_s B_s x_s^T
        wst = torch.exp(total[:, None, :] - cs) * dtb  # (B,L,H)
        h = h * torch.exp(total)[..., None, None] + torch.einsum(
            "blh,blhp,blhn->bhpn", wst, xb.float(), bb.float())
        ys.append((y_intra + y_state).to(x.dtype))
    return torch.stack(ys, dim=1).reshape(B, S, H, P), h


def mamba2_decode_step(x, dt, A, Bm, Cm, h):
    """Single-token SSD update: x (B,H,P), dt (B,H), Bm/Cm (B,G,N), h (B,H,P,N)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1)
    Ch = Cm.repeat_interleave(rep, dim=1)
    decay = torch.exp(dt * A[None, :])
    upd = dt[..., None, None] * (x[..., :, None] * Bh[..., None, :])
    h = h * decay[..., None, None] + upd.float()
    y = torch.einsum("bhpn,bhn->bhp", h, Ch.float())
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# RWKV6 (Finch) scan
# ---------------------------------------------------------------------------
def rwkv6_scan_naive(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor,
                     s0: Optional[torch.Tensor] = None):
    """Token-by-token WKV6:
        y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T
    r/k/w (B,S,H,K), v (B,S,H,V), u (H,K), s0 (B,H,K,V).
    Returns (y (B,S,H,V) in v's dtype, S_final float32)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(S):
        kv = k[:, t][..., :, None] * v[:, t][..., None, :]  # (B,H,K,V), inputs' dtype
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t].float(),
                               s + u[None, :, :, None] * kv.float()))
        s = torch.exp(w[:, t].float())[..., None] * s + kv.float()
    return torch.stack(ys, dim=1).to(v.dtype), s


def rwkv6_scan_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       s0: Optional[torch.Tensor] = None, chunk: int = 64):
    """Chunked WKV6 with per-channel data-dependent decay: dense (t, s)
    matrices per chunk, the state carried exactly between chunks.  The
    decay between t > s is exp(cw_excl_t - cw_s) per channel, a difference
    of prefix sums inside the chunk (never positive).  ``S`` must be a
    multiple of ``chunk``."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    if S % chunk:
        raise ValueError("S must divide chunk")
    nc = S // chunk
    rc = r.reshape(B, nc, chunk, H, K).float()
    kc = k.reshape(B, nc, chunk, H, K).float()
    vc = v.reshape(B, nc, chunk, H, V).float()
    wc = w.reshape(B, nc, chunk, H, K).float()
    # (1,t,s,1,1): strict pairs s < t; the exponent is masked, not the exp
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                      diagonal=-1)[None, :, :, None, None]
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for i in range(nc):
        rb, kb, vb, wb = rc[:, i], kc[:, i], vc[:, i], wc[:, i]
        cw = torch.cumsum(wb, dim=1)  # inclusive (B,L,H,K)
        cw_excl = cw - wb
        # state term: (r_t * exp(cw_excl_t)) @ S
        y_state = torch.einsum("blhk,bhkv->blhv", rb * torch.exp(cw_excl), s)
        # intra-chunk pairs s < t: exp(cw_excl_t - cw_s) r_t.k_s
        expo = torch.where(mask, cw_excl[:, :, None] - cw[:, None, :], NEG_INF)
        qk = torch.einsum("blhk,bmhk,blmhk->blmh", rb, kb, torch.exp(expo))
        y_intra = torch.einsum("blmh,bmhv->blhv", qk, vb)
        # the current token through the bonus u instead of a decay
        y_diag = torch.einsum("blhk,hk,blhk->blh", rb, u.float(), kb)[..., None] * vb
        # S' = diag(exp(cw_L)) S + sum_s exp(cw_L - cw_s) k_s v_s^T
        total = cw[:, -1]  # (B,H,K)
        s = torch.exp(total)[..., None] * s + torch.einsum(
            "blhk,blhv->bhkv", kb * torch.exp(total[:, None] - cw), vb)
        ys.append((y_state + y_intra + y_diag).to(v.dtype))
    return torch.stack(ys, dim=1).reshape(B, S, H, V), s


def rwkv6_decode_step(r, k, v, w, u, s):
    """Single-token WKV6 update for serving: r/k/w (B,H,K), v (B,H,V)."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r.float(), s + u[None, :, :, None] * kv.float())
    s = torch.exp(w.float())[..., None] * s + kv.float()
    return y.to(v.dtype), s
