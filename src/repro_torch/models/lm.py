"""Decoder-only LM over a per-layer block pattern (PyTorch port).

Twin of the reference's ``models/lm.py`` for the blocks ported so far:
``attn`` blocks with a dense ``mlp`` FFN.  Layers are grouped into runs of
identical (block kind, ffn kind), and each run's parameters are stacked
with a leading layer axis, so the parameter tree has the reference's leaf
names and shapes.  The reference's ``lax.scan`` over a stack is a Python
loop over the leading axis here.

API:
  init(cfg, gen) -> params
  logits_fn(cfg, params, batch) -> (B,S,V) float32 logits
  init_cache(cfg, batch, max_len, device) -> list of stacked caches
  prefill(cfg, params, batch, max_len) -> (last_logits, cache)
  decode_step(cfg, params, cache, token, pos) -> (logits, cache)

The cache is updated in place; ``prefill``/``decode_step`` return it too,
to keep the reference's signatures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from . import attention as attn
from . import mlp as mlpm
from .common import (apply_norm, dense_init, embed_tokens, embedding_init,
                     lm_head_logits, norm_init, positions_for)
from .config import ModelConfig, check_supported

Tree = Dict[str, Any]


@dataclass(frozen=True)
class LayerGroup:
    kind: str      # attn (the only block ported so far)
    ffn: str       # mlp
    start: int     # absolute index of first layer in the group
    count: int


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    check_supported(cfg)
    return [LayerGroup("attn", "mlp", 0, cfg.n_layers)]


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: List[Tree]) -> Tree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _block_init(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    return {
        "ln1": norm_init(cfg, gen.device),
        "attn": attn.attn_init(cfg, gen),
        "ffn": mlpm.mlp_init(cfg, gen),
        "ln2": norm_init(cfg, gen.device),
    }


def init(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    """Random weights on ``gen.device`` with the reference's distributions."""
    layers = [_stack([_block_init(cfg, gen) for _ in range(g.count)])
              for g in layer_groups(cfg)]
    return {
        "embed": embedding_init(cfg, gen),
        "final_norm": norm_init(cfg, gen.device),
        "layers": layers,
        "lm_head": dense_init(gen, cfg.d_model, (cfg.padded_vocab,),
                              cfg.param_tdtype()).t().contiguous(),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _attn_layer(cfg: ModelConfig, lp: Tree, x: torch.Tensor, mix) -> torch.Tensor:
    """Pre-norm residual block: x + mix(norm(x)), then x + mlp(norm(x))."""
    x = x + mix(apply_norm(cfg, lp["ln1"], x))
    return x + mlpm.mlp_apply(cfg, lp["ffn"], apply_norm(cfg, lp["ln2"], x))


def logits_fn(cfg: ModelConfig, params: Tree, batch: Dict) -> torch.Tensor:
    """Full-sequence logits (B,S,V) — tiny shapes and tests only."""
    x = embed_tokens(cfg, params["embed"], batch["tokens"])
    positions = positions_for(cfg, batch)
    for gi, g in enumerate(layer_groups(cfg)):
        for i in range(g.count):
            lp = _index(params["layers"][gi], i)
            x = _attn_layer(cfg, lp, x,
                            lambda h: attn.attn_apply(cfg, lp["attn"], h, positions))
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_head_logits(cfg, params["embed"], params.get("lm_head"), x)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device) -> List[Tree]:
    """One stacked cache tree per layer group: k/v (count, B, max_len, KV, hd)."""
    dt = cfg.compute_tdtype()
    out = []
    for g in layer_groups(cfg):
        one = attn.attn_init_cache(cfg, batch, max_len, dt, device)
        out.append({k: torch.zeros((g.count, *v.shape), dtype=dt, device=device)
                    for k, v in one.items()})
    return out


def prefill(cfg: ModelConfig, params: Tree, batch: Dict,
            max_len: int) -> tuple:
    """Process a prompt of S tokens; return last-position logits and the
    primed cache (max_len slots)."""
    tokens = batch["tokens"]
    B, _ = tokens.shape
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = positions_for(cfg, batch)
    cache = init_cache(cfg, B, max_len, tokens.device)
    for gi, g in enumerate(layer_groups(cfg)):
        for i in range(g.count):
            lp = _index(params["layers"][gi], i)
            c = _index(cache[gi], i)
            x = _attn_layer(cfg, lp, x, lambda h: attn.attn_prefill(
                cfg, lp["attn"], h, positions, c)[0])
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head_logits(cfg, params["embed"], params.get("lm_head"), x[:, -1])
    return logits, cache


def decode_step(cfg: ModelConfig, params: Tree, cache: List[Tree],
                token: torch.Tensor, pos: torch.Tensor) -> tuple:
    """One decode step.  token: (B,), pos: (B,) int32 -> logits (B, V)."""
    x = embed_tokens(cfg, params["embed"], token[:, None])
    for gi, g in enumerate(layer_groups(cfg)):
        for i in range(g.count):
            lp = _index(params["layers"][gi], i)
            c = _index(cache[gi], i)
            x = _attn_layer(cfg, lp, x, lambda h: attn.attn_decode(
                cfg, lp["attn"], h, pos, c)[0])
    x = apply_norm(cfg, params["final_norm"], x)
    logits = lm_head_logits(cfg, params["embed"], params.get("lm_head"), x[:, 0])
    return logits, cache
