"""Attention blocks, twins of the reference's: GQA/MQA (``attn_*``) with
RoPE or M-RoPE and optional qkv biases, and DeepSeek-V2's multi-head
latent attention (``mla_*``).

Activations are (B,S,H,hd); the kernels take (B,H,S,hd), which here is a
transposed view, not a copy.  The KV cache is stored (B,T,KV,hd) as in the
reference and handed to decode attention as a transposed view too.

The reference updates its cache functionally (``dynamic_update_slice``);
the port writes the cache in place and returns the same dict.  Positions
must lie inside the cache (``pos < max_len``), which the generate loop
guarantees; out-of-range writes raise instead of being clamped.

MLA caches only the normalised latent ``ckv`` (B,T,kv_lora) and the shared
rope key ``kpe`` (B,T,qk_rope).  Prefill expands them to per-head keys and
values and runs the flash kernel at head_dim qk_nope + qk_rope, V
zero-padded to that width and sliced back, as the reference.  Decode stays
in the latent space (``k_up`` absorbed into the query, ``v_up`` applied to
the attended latent), plain torch as in the reference.  The reference's
prefill projects the prompt twice, once for the cache and once inside
``mla_apply``; here once, for both: the same values.  Under
``rope_type="yarn"`` the rope dims take YaRN's frequencies and the softmax
scale its temperature (:func:`mla_softmax_scale`), as DeepSeek-V2's
published code, which the reference lacks; the rope dims stay split-half,
where the published checkpoint stores them interleaved (a fixed permutation
of ``q_up``'s and ``kv_down``'s rope columns for seeded weights).  Each MLA
block of a prefill is an ``attn: mla`` span, also on the device's clock;
the training forward and decode steps open none.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch import spans
from .common import (apply_mrope, apply_norm, apply_rope, apply_rotary, constrain_dims,
                     dense_init, init_device, is_dtensor, norm_init, yarn_mscale, zero_pad)
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
        dev = init_device(gen)
        p["bq"] = torch.zeros((H, hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((KV, hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((KV, hd), dtype=dt, device=dev)
    return p


def _split(w: torch.Tensor) -> bool:
    """A DTensor that is not whole on every rank (the dry-run lays weights
    out by their specs; the trainer and server replicate them)."""
    return is_dtensor(w) and not all(p.is_replicate() for p in w.placements)


def _whole(w: torch.Tensor) -> torch.Tensor:
    """A split DTensor weight gathered whole: DTensor splits the products
    of a split (heads, head_dim) weight, and their gradients, along the
    flat (H * hd) dim where the heads do not divide, and then cannot
    regroup them into (H, hd)."""
    from torch.distributed.tensor import Replicate
    return w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product (over a split DTensor
    weight, gathered whole first: :func:`_whole`)."""
    w = _whole(w) if _split(w) else w
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
    # heads on "model"; where the head count does not divide it (28 heads,
    # MQA) q falls back to the sequence and k/v stay replicated over it
    q = constrain_dims(q, {0: "dp", 2: "model", 1: "model"})
    k = constrain_dims(k, {0: "dp", 2: "model"})
    v = constrain_dims(v, {0: "dp", 2: "model"})
    return q, k, v


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum('bshk,hkd->bsd') as one matrix product; o is (B,S,H,hd)."""
    wo = _whole(wo) if _split(wo) else wo
    H, hd, D = wo.shape
    return o.reshape(*o.shape[:2], H * hd) @ wo.to(o.dtype).reshape(H * hd, D)


def attn_apply(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
               positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D), full-sequence causal attention."""
    q, k, v = _qkv(cfg, p, x, positions)
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, impl=cfg.attn_impl)
    o = constrain_dims(o.transpose(1, 2), {0: "dp", 2: "model", 1: "model"})
    return _out(o, p["wo"])


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


def _write_rows(cache: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> None:
    """cache[b, idx[b]] = val[b] for every row b, in place.  A DTensor cache
    (rows over the data axes, as ``lm.init_cache`` lays it out) is written
    shard by shard: DTensor has no in-place indexed write on a sharded dim."""
    if is_dtensor(cache):
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = cache.device_mesh
        rows = [p if p == Shard(0) else Replicate() for p in cache.placements]

        def local(t):
            if not is_dtensor(t):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
            return t.redistribute(mesh, rows).to_local()

        cache, idx, val = cache.to_local(), local(idx), local(val)
    cache[torch.arange(cache.shape[0], device=cache.device), idx] = val


def attn_decode(cfg: ModelConfig, p: Tensors, x: torch.Tensor, pos: torch.Tensor,
                cache: Tensors) -> Tuple[torch.Tensor, Tensors]:
    """x: (B,1,D); pos: (B,) int32 current position; in-cache attention."""
    B = x.shape[0]
    positions = pos[None, :, None].expand(3, B, 1) if cfg.rope_type == "mrope" else pos[:, None]
    q, k, v = _qkv(cfg, p, x, positions)
    idx = pos.long()
    _write_rows(cache["k"], idx, k[:, 0])
    _write_rows(cache["v"], idx, v[:, 0])
    o = ops.decode_attention(q[:, 0], cache["k"].transpose(1, 2),
                             cache["v"].transpose(1, 2), pos + 1,
                             impl=cfg.attn_impl)
    return _out(o[:, None], p["wo"]), cache


# ---------------------------------------------------------------------------
# DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------
def mla_init(cfg: ModelConfig, gen: torch.Generator) -> Tensors:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    dt = cfg.param_tdtype()
    dev = init_device(gen)
    return {
        "q_down": dense_init(gen, D, (m.q_lora,), dt),
        "q_norm": norm_init(cfg, dev, m.q_lora),
        "q_up": dense_init(gen, m.q_lora, (H, m.qk_nope + m.qk_rope), dt),
        "kv_down": dense_init(gen, D, (m.kv_lora + m.qk_rope,), dt),
        "kv_norm": norm_init(cfg, dev, m.kv_lora),
        "k_up": dense_init(gen, m.kv_lora, (H, m.qk_nope), dt),
        "v_up": dense_init(gen, m.kv_lora, (H, m.v_head), dt),
        "wo": dense_init(gen, H * m.v_head, (D,), dt).reshape(H, m.v_head, D),
    }


def _mla_qkv(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
             positions: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """x (B,S,D) -> q_nope (B,S,H,qk_nope), q_pe (B,S,H,qk_rope), the
    normalised latent ckv (B,S,kv_lora) and the shared rope key k_pe
    (B,S,qk_rope); positions (B,S)."""
    m = cfg.mla
    cq = apply_norm(cfg, p["q_norm"], x @ p["q_down"].to(x.dtype))
    q = _proj(cq, p["q_up"])
    ckv_full = x @ p["kv_down"].to(x.dtype)
    ckv = apply_norm(cfg, p["kv_norm"], ckv_full[..., :m.kv_lora])
    q_pe = apply_rotary(cfg, q[..., m.qk_nope:], positions)
    k_pe = apply_rotary(cfg, ckv_full[..., None, m.kv_lora:], positions)[:, :, 0]
    q_nope = constrain_dims(q[..., :m.qk_nope], {0: "dp", 2: "model"})
    q_pe = constrain_dims(q_pe, {0: "dp", 2: "model"})
    return q_nope, q_pe, ckv, k_pe


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """(qk_nope + qk_rope)^-1/2, under YaRN times mscale(yarn_mscale_all_dim)
    squared (DeepSeek-V2's ``softmax_scale``; 1.58963 at its published
    factor 40 and 0.707)."""
    m = cfg.mla
    scale = (m.qk_nope + m.qk_rope) ** -0.5
    if cfg.rope_type == "yarn" and cfg.yarn_mscale_all_dim:
        scale *= yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def _mla_attend(cfg: ModelConfig, p: Tensors, q_nope: torch.Tensor, q_pe: torch.Tensor,
                ckv: torch.Tensor, k_pe: torch.Tensor, causal: bool) -> torch.Tensor:
    """Per-head keys and values from the latent, attention at head_dim
    qk_nope + qk_rope (V zero-padded to it, sliced back), then ``wo``."""
    m = cfg.mla
    k_nope = constrain_dims(_proj(ckv, p["k_up"]), {0: "dp", 2: "model"})
    v = constrain_dims(_proj(ckv, p["v_up"]), {0: "dp", 2: "model"})
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(*k_nope.shape[:3], m.qk_rope)], -1)
    v = zero_pad(v, (0, q.shape[-1] - m.v_head))
    o = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
                      scale=mla_softmax_scale(cfg), impl=cfg.attn_impl)
    o = constrain_dims(o.transpose(1, 2)[..., :m.v_head], {0: "dp", 2: "model"})
    return _out(o, p["wo"])


def mla_apply(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """x: (B,S,D) -> (B,S,D), full-sequence causal attention."""
    return _mla_attend(cfg, p, *_mla_qkv(cfg, p, x, positions), causal)


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype: torch.dtype, device: torch.device) -> Tensors:
    """The latent and the shared rope key only: kv_lora + qk_rope values a
    token instead of 2 * H * head_dim."""
    m = cfg.mla
    return {"ckv": torch.zeros((batch, max_len, m.kv_lora), dtype=dtype, device=device),
            "kpe": torch.zeros((batch, max_len, m.qk_rope), dtype=dtype, device=device)}


def mla_prefill(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                positions: torch.Tensor,
                cache: Tensors) -> Tuple[torch.Tensor, Tensors]:
    """Prompt of S tokens: write cache[:, :S] in place, attend causally."""
    with spans.span("attn: mla", device=x.device):
        q_nope, q_pe, ckv, k_pe = _mla_qkv(cfg, p, x, positions)
        S = x.shape[1]
        cache["ckv"][:, :S] = ckv
        cache["kpe"][:, :S] = k_pe
        return _mla_attend(cfg, p, q_nope, q_pe, ckv, k_pe, True), cache


def mla_latent_attention(q_lat: torch.Tensor, q_pe: torch.Tensor, ckv: torch.Tensor,
                         kpe: torch.Tensor, length: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Decode attention in the latent space: q_lat (B,H,kv_lora) and q_pe
    (B,H,qk_rope) against the cache ckv (B,T,kv_lora) and kpe (B,T,qk_rope),
    keys t < length[b] visible; -> the attended latent (B,H,kv_lora).  The
    scores are summed and scaled in the compute dtype, masked and
    normalised in fp32, as the reference."""
    logits = (torch.einsum("bhl,btl->bht", q_lat, ckv)
              + torch.einsum("bhk,btk->bht", q_pe, kpe)) * scale
    mask = torch.arange(ckv.shape[1], device=ckv.device)[None, None, :] \
        < length[:, None, None]
    logits = torch.where(mask, logits.float(), -1e30)
    w = torch.softmax(logits, dim=-1).to(q_lat.dtype)
    return torch.einsum("bht,btl->bhl", w, ckv)


def mla_decode(cfg: ModelConfig, p: Tensors, x: torch.Tensor, pos: torch.Tensor,
               cache: Tensors) -> Tuple[torch.Tensor, Tensors]:
    """x: (B,1,D); pos: (B,) int32.  The query is projected into the latent
    space (``k_up`` absorbed), so attention reads the (kv_lora + qk_rope)
    cache directly: the MLA serving trick."""
    q_nope, q_pe, ckv, k_pe = _mla_qkv(cfg, p, x, pos[:, None])
    idx = pos.long()
    _write_rows(cache["ckv"], idx, ckv[:, 0])
    _write_rows(cache["kpe"], idx, k_pe[:, 0])
    q_lat = torch.einsum("bhk,lhk->bhl", q_nope[:, 0], p["k_up"].to(x.dtype))
    ctx = mla_latent_attention(q_lat, q_pe[:, 0], cache["ckv"], cache["kpe"], pos + 1,
                               mla_softmax_scale(cfg))
    o = torch.einsum("bhl,lhk->bhk", ctx, p["v_up"].to(x.dtype))
    return _out(o[:, None], p["wo"]), cache
