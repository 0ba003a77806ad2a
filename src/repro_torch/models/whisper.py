"""Whisper-style encoder-decoder (PyTorch port; conv frontend stubbed).

Twin of the reference's ``models/whisper.py``, with its names and its
parameter tree: ``embed``, ``pos_dec`` (32776, d), ``enc_layers`` and
``dec_layers`` (lists of per-layer dicts, not stacked), ``enc_norm`` and
``dec_norm``.  The batch carries precomputed frame embeddings
(B, n_audio_ctx, d_model) in place of the mel-spectrogram conv stem.
Everything downstream is real: sinusoidal encoder positions,
bidirectional encoder self-attention, causal decoder self-attention and
cross-attention against the encoder's output, the tied head.

On the card the encoder's self-attention and the cross-attention of a
prompt run the flash kernel non-causally (S = T = n_audio_ctx, and S
prompt rows against T = n_audio_ctx keys), the decoder's self-attention
runs it causally, and decode runs the decode kernel against the
self-attention cache.  The cross-attention of a decode step is pinned to
the plain ``ref`` decode (``kernels.ref.decode_attention_naive``), as the
reference pins it: plain torch on the card too.

The self-attention cache is written in place (``attention.attn_prefill``,
``attn_decode``); ``prefill``/``decode_step`` return it too, to keep the
reference's signatures.  ``loss`` runs each decoder layer under
``torch.utils.checkpoint`` when ``cfg.remat`` is set, with nothing saved
whatever ``cfg.remat_policy`` says (the reference's ``jax.checkpoint(run)``
has no policy), and the layer's cross keys and values are recomputed
inside it.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops, ref
from . import attention as attn
from . import mlp as mlpm
from .common import (apply_norm, chunked_softmax_xent, embed_tokens, embedding_init,
                     init_device, lm_head_logits, norm_init)
from .config import ModelConfig

Tree = Dict[str, Any]

POS_DEC_ROWS = 32768 + 8  # the reference's learned decoder positions


def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """(length, channels) fp32: sin then cos of the reference's timescales."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(channels // 2, dtype=torch.float32,
                                                  device=device))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


def init(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    """Random weights on ``init_device(gen)`` with the reference's distributions."""
    dev = init_device(gen)
    p: Tree = {
        "embed": embedding_init(cfg, gen),
        "pos_dec": (torch.randn((POS_DEC_ROWS, cfg.d_model), generator=gen, device=dev)
                    * 0.01).to(cfg.param_tdtype()),
        "enc_layers": [], "dec_layers": [],
        "enc_norm": norm_init(cfg, dev), "dec_norm": norm_init(cfg, dev),
    }
    for _ in range(cfg.enc_dec.n_enc_layers):
        p["enc_layers"].append({
            "ln1": norm_init(cfg, dev), "attn": attn.attn_init(cfg, gen),
            "ln2": norm_init(cfg, dev), "mlp": mlpm.mlp_init(cfg, gen),
        })
    for _ in range(cfg.n_layers):
        p["dec_layers"].append({
            "ln1": norm_init(cfg, dev), "attn": attn.attn_init(cfg, gen),
            "lnx": norm_init(cfg, dev), "xattn": attn.attn_init(cfg, gen),
            "ln2": norm_init(cfg, dev), "mlp": mlpm.mlp_init(cfg, gen),
        })
    return p


def _self_attn(cfg: ModelConfig, bp: Tree, x: torch.Tensor, positions: torch.Tensor,
               causal: bool) -> torch.Tensor:
    h = apply_norm(cfg, bp["ln1"], x)
    return x + attn.attn_apply(cfg, bp["attn"], h, positions, causal=causal)


def _cross_q(cfg: ModelConfig, bp: Tree, h: torch.Tensor) -> torch.Tensor:
    q = attn._proj(h, bp["xattn"]["wq"])
    if cfg.qkv_bias:
        q = q + bp["xattn"]["bq"].to(h.dtype)
    return q


def _cross_attn(cfg: ModelConfig, bp: Tree, x: torch.Tensor, mem_k: torch.Tensor,
                mem_v: torch.Tensor) -> torch.Tensor:
    """Against the pre-projected encoder memory keys/values (B,H,T,hd)."""
    h = apply_norm(cfg, bp["lnx"], x)
    q = _cross_q(cfg, bp, h)
    o = ops.attention(q.transpose(1, 2), mem_k, mem_v, causal=False, impl=cfg.attn_impl)
    return x + attn._out(o.transpose(1, 2), bp["xattn"]["wo"])


def _cross_decode(cfg: ModelConfig, bp: Tree, x: torch.Tensor, mem_k: torch.Tensor,
                  mem_v: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention over all T memory positions, plain."""
    h = apply_norm(cfg, bp["lnx"], x)
    q = _cross_q(cfg, bp, h)
    B, T = q.shape[0], mem_k.shape[2]
    length = torch.full((B,), T, dtype=torch.int32, device=x.device)
    o = ref.decode_attention_naive(q[:, 0], mem_k, mem_v, length)
    return x + attn._out(o[:, None], bp["xattn"]["wo"])


def _mlp(cfg: ModelConfig, bp: Tree, x: torch.Tensor) -> torch.Tensor:
    return x + mlpm.mlp_apply(cfg, bp["mlp"], apply_norm(cfg, bp["ln2"], x))


def _mem_kv(cfg: ModelConfig, bp: Tree, mem: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross keys and values of the encoder output, (B,H,T,hd) views of
    (B,T,H,hd) projections."""
    k, v = attn._proj(mem, bp["xattn"]["wk"]), attn._proj(mem, bp["xattn"]["wv"])
    if cfg.qkv_bias:
        k = k + bp["xattn"]["bk"].to(mem.dtype)
        v = v + bp["xattn"]["bv"].to(mem.dtype)
    return k.transpose(1, 2), v.transpose(1, 2)


def encode(cfg: ModelConfig, params: Tree, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T_audio, D) precomputed embeddings (conv stub)."""
    B, T, D = frames.shape
    dt = cfg.compute_tdtype()
    x = frames.to(dt) + sinusoids(T, D, frames.device).to(dt)[None]
    positions = torch.arange(T, device=frames.device)[None].expand(B, T)
    for bp in params["enc_layers"]:
        x = _self_attn(cfg, bp, x, positions, causal=False)
        x = _mlp(cfg, bp, x)
    return apply_norm(cfg, params["enc_norm"], x)


def _decoder_embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
                   pos0: int = 0) -> torch.Tensor:
    x = embed_tokens(cfg, params["embed"], tokens)
    return x + params["pos_dec"][pos0:pos0 + tokens.shape[1]].to(x.dtype)[None]


def loss(cfg: ModelConfig, params: Tree, batch: Dict) -> torch.Tensor:
    """batch: frames (B,T,D), tokens (B,S), labels (B,S)."""
    mem = encode(cfg, params, batch["frames"])
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _decoder_embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    def run(bp, x):
        mk, mv = _mem_kv(cfg, bp, mem)
        h = _self_attn(cfg, bp, x, positions, causal=True)
        h = _cross_attn(cfg, bp, h, mk, mv)
        return _mlp(cfg, bp, h)

    for bp in params["dec_layers"]:
        if cfg.remat and torch.is_grad_enabled():
            x = checkpoint(run, bp, x, use_reentrant=False)
        else:
            x = run(bp, x)
    x = apply_norm(cfg, params["dec_norm"], x)
    return chunked_softmax_xent(cfg, params["embed"], None, x, batch["labels"],
                                batch.get("loss_mask"))


# -- serving ------------------------------------------------------------------
def init_cache(cfg: ModelConfig, params: Tree, mem: torch.Tensor, max_len: int) -> Tree:
    """Self-attention caches and the precomputed cross K/V of each decoder
    layer."""
    B = mem.shape[0]
    layers = []
    for bp in params["dec_layers"]:
        mk, mv = _mem_kv(cfg, bp, mem)
        layers.append({"self": attn.attn_init_cache(cfg, B, max_len, cfg.compute_tdtype(),
                                                    mem.device),
                       "mem_k": mk, "mem_v": mv})
    return {"layers": layers}


def prefill(cfg: ModelConfig, params: Tree, batch: Dict, max_len: int) -> Tuple[torch.Tensor, Tree]:
    mem = encode(cfg, params, batch["frames"])
    cache = init_cache(cfg, params, mem, max_len)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = _decoder_embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for bp, lc in zip(params["dec_layers"], cache["layers"]):
        h = apply_norm(cfg, bp["ln1"], x)
        x = x + attn.attn_prefill(cfg, bp["attn"], h, positions, lc["self"])[0]
        x = _cross_attn(cfg, bp, x, lc["mem_k"], lc["mem_v"])
        x = _mlp(cfg, bp, x)
    x = apply_norm(cfg, params["dec_norm"], x)
    return lm_head_logits(cfg, params["embed"], None, x[:, -1]), cache


def decode_step(cfg: ModelConfig, params: Tree, cache: Tree, token: torch.Tensor,
                pos: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
    """One decode step.  token: (B,), pos: (B,) int32 device tensor."""
    x = embed_tokens(cfg, params["embed"], token[:, None])
    x = x + params["pos_dec"][pos.long()].to(x.dtype)[:, None]
    for bp, lc in zip(params["dec_layers"], cache["layers"]):
        h = apply_norm(cfg, bp["ln1"], x)
        x = x + attn.attn_decode(cfg, bp["attn"], h, pos, lc["self"])[0]
        x = _cross_decode(cfg, bp, x, lc["mem_k"], lc["mem_v"])
        x = _mlp(cfg, bp, x)
    x = apply_norm(cfg, params["dec_norm"], x)
    return lm_head_logits(cfg, params["embed"], None, x[:, 0]), cache
