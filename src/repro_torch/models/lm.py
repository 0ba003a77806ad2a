"""Decoder-only LM over a per-layer block pattern (PyTorch port).

Twin of the reference's ``models/lm.py`` for the blocks ported so far:
``attn`` blocks with a dense ``mlp`` FFN (TinyLlama, Gemma, Command-R,
Qwen2-VL: sequential or parallel attention and MLP, tied or untied head,
visual embeddings spliced over the first token slots) or a ``moe`` FFN
(Granite-MoE; leading ``dense`` layers of width ``moe.dense_d_ff``),
``mla`` blocks with the same FFN kinds (DeepSeek-V2), ``mamba2`` blocks with a ``shared_attn`` block (Zamba2), and ``rwkv6``
blocks.  Layers are grouped into runs of identical (block kind, ffn kind);
each ``shared_attn`` stands alone.  Each run's parameters are stacked with
a leading layer axis, and a
``shared_attn`` group holds ``{}`` in ``layers`` while the one shared block
sits unstacked in ``shared_block``, so the parameter tree has the
reference's leaf names and shapes.  The reference's ``lax.scan`` over a
stack is a Python loop over the leading axis here.

API:
  init(cfg, gen) -> params
  loss(cfg, params, batch) -> scalar                 (train)
  backbone(cfg, params, batch) -> (final hidden states, aux loss)
  logits_fn(cfg, params, batch) -> (B,S,V) float32 logits
  init_cache(cfg, batch, max_len, device) -> list of stacked caches
  prefill(cfg, params, batch, max_len) -> (last_logits, cache)
  decode_step(cfg, params, cache, token, pos) -> (logits, cache)

The cache is updated in place; ``prefill``/``decode_step`` return it too,
to keep the reference's signatures.

Training differentiates through the same forward.  A stacked run is split
into per-layer views with ``unbind``, whose backward stacks the layers'
gradients into the stacked leaf in one copy; the shared block's gradients
add up over its uses, as through the reference's scans.  ``cfg.remat``
runs each layer under ``torch.utils.checkpoint``: with ``remat_policy``
``"dots"`` selectively, saving the outputs of 2-D matrix products (the
reference's ``dots_with_no_batch_dims_saveable``), else saving nothing
(its ``nothing_saveable``).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from . import attention as attn
from . import mlp as mlpm
from . import ssm
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from .common import (active_mesh, apply_norm, batch_zeros, chunked_softmax_xent,
                     constrain_batch, dense_init, embed_tokens, embedding_init, init_device,
                     is_dtensor, lm_head_logits, merge_visual, norm_init, positions_for, remat)
from .config import ModelConfig, check_supported

Tree = Dict[str, Any]


@dataclass(frozen=True)
class LayerGroup:
    kind: str      # attn | mla | mamba2 | rwkv6 | shared_attn
    ffn: str       # moe | mlp | dense | none
    start: int     # absolute index of first layer in the group
    count: int


def _ffn_kind(cfg: ModelConfig, layer_idx: int) -> str:
    kind = cfg.blocks[layer_idx]
    if kind in ("mamba2", "rwkv6"):
        return "none"
    m = cfg.moe
    if m is None:
        return "mlp"
    return "moe" if layer_idx >= m.first_dense_layers else "dense"


def layer_groups(cfg: ModelConfig) -> List[LayerGroup]:
    check_supported(cfg)
    groups: List[LayerGroup] = []
    for i, kind in enumerate(cfg.blocks):
        sig = (kind, _ffn_kind(cfg, i))
        if groups and kind != "shared_attn" \
                and (groups[-1].kind, groups[-1].ffn) == sig:
            g = groups[-1]
            groups[-1] = LayerGroup(g.kind, g.ffn, g.start, g.count + 1)
        else:
            groups.append(LayerGroup(kind, sig[1], i, 1))
    return groups


def _index(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stacked(make: Callable[[], Tree], count: int) -> Tree:
    """``count`` trees from ``make`` stacked on a leading axis, filled layer
    by layer so that only one unstacked layer is alive at a time."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((count, *t.shape))

    def put(dst, src, i):
        if isinstance(dst, dict):
            for k in dst:
                put(dst[k], src[k], i)
        else:
            dst[i] = src

    first = make()
    out = alloc(first)
    put(out, first, 0)
    del first
    for i in range(1, count):
        put(out, make(), i)
    return out


def _unstack(tree: Tree, count: int) -> List[Tree]:
    """The ``count`` layers of a stacked tree, as views (``unbind``).  A
    DTensor split along the layer axis (as the dry-run lays some stacks out)
    is gathered along it first: DTensor cannot unbind a split dim."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: v[i] for k, v in per.items()} for i in range(count)]
    if is_dtensor(tree) and any(p.is_shard(0) for p in tree.placements):
        from torch.distributed.tensor import Replicate
        tree = tree.redistribute(tree.device_mesh, [Replicate() if p.is_shard(0) else p
                                                    for p in tree.placements])
    return list(tree.unbind(0))


def _walk(cfg: ModelConfig, params: Tree) -> Iterator[Tuple[int, int, str, str, Tree]]:
    """(group index, index in the group, block kind, ffn kind, layer params)
    for every layer in order; a ``shared_attn`` layer gets the shared block
    and its dense MLP."""
    for gi, g in enumerate(layer_groups(cfg)):
        if g.kind == "shared_attn":
            for i in range(g.count):
                yield gi, i, "attn", "mlp", params["shared_block"]
        else:
            for i, lp in enumerate(_unstack(params["layers"][gi], g.count)):
                yield gi, i, g.kind, g.ffn, lp


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _ffn_init(cfg: ModelConfig, ffn: str, gen: torch.Generator) -> Tree:
    if ffn == "moe":
        return mlpm.moe_init(cfg, gen)
    if ffn == "dense":
        return mlpm.mlp_init(cfg, gen, d_ff=cfg.moe.dense_d_ff)
    return mlpm.mlp_init(cfg, gen)


def _block_init(cfg: ModelConfig, kind: str, ffn: str, gen: torch.Generator) -> Tree:
    dev = init_device(gen)
    if kind in ("attn", "mla"):
        mix = attn.attn_init(cfg, gen) if kind == "attn" else attn.mla_init(cfg, gen)
        p = {"ln1": norm_init(cfg, dev), "attn": mix, "ffn": _ffn_init(cfg, ffn, gen)}
        if not cfg.parallel_block:
            p["ln2"] = norm_init(cfg, dev)
        return p
    if kind == "mamba2":
        return {"ln1": norm_init(cfg, dev), "mixer": ssm.mamba2_init(cfg, gen)}
    if kind == "rwkv6":
        return {"ln1": norm_init(cfg, dev), "tm": ssm.rwkv6_init(cfg, gen),
                "ln2": norm_init(cfg, dev)}
    raise ValueError(kind)


def init(cfg: ModelConfig, gen: torch.Generator) -> Tree:
    """Random weights on ``init_device(gen)`` with the reference's distributions."""
    layers = [{} if g.kind == "shared_attn"
              else _stacked(lambda: _block_init(cfg, g.kind, g.ffn, gen), g.count)
              for g in layer_groups(cfg)]
    params: Tree = {
        "embed": embedding_init(cfg, gen),
        "final_norm": norm_init(cfg, init_device(gen)),
        "layers": layers,
    }
    if "shared_attn" in cfg.blocks:
        params["shared_block"] = _block_init(cfg, "attn", "mlp", gen)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, (cfg.padded_vocab,),
                                       cfg.param_tdtype()).t().contiguous()
    if cfg.rwkv is not None:
        params["ln0"] = norm_init(cfg, init_device(gen))
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _apply_ffn(cfg: ModelConfig, ffn: str, fp: Tree, h: torch.Tensor,
               serve: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, aux loss); only a ``moe`` FFN has an aux loss, the others None."""
    if ffn == "moe":
        return mlpm.moe_apply(cfg, fp, h, serve=serve)
    return mlpm.mlp_apply(cfg, fp, h), None


def _attn_layer(cfg: ModelConfig, ffn: str, lp: Tree, x: torch.Tensor, mix,
                serve: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Pre-norm residual block: x + mix(norm(x)), then x + ffn(norm(x));
    with ``parallel_block`` both read the one norm: x + mix(h) + ffn(h).
    Returns the new x and the FFN's aux loss."""
    h = apply_norm(cfg, lp["ln1"], x)
    if cfg.parallel_block:
        f, aux = _apply_ffn(cfg, ffn, lp["ffn"], h, serve)
        return x + mix(h) + f, aux
    x = x + mix(h)
    if not serve:
        # the residual batch-only at the sum, as the reference's training
        # block (its serving blocks leave it to propagation)
        x = constrain_batch(x)
    f, aux = _apply_ffn(cfg, ffn, lp["ffn"], apply_norm(cfg, lp["ln2"], x), serve)
    return x + f, aux


def _embed(cfg: ModelConfig, params: Tree, tokens: torch.Tensor,
           batch: Optional[Dict] = None) -> torch.Tensor:
    """Token embeddings; with a ``batch`` (the prompt, not a decode step)
    its visual embeddings take the first token slots."""
    x = embed_tokens(cfg, params["embed"], tokens)
    if batch is not None:
        x = merge_visual(cfg, x, batch)
    if cfg.rwkv is not None:
        x = apply_norm(cfg, params["ln0"], x)
    return x


def _head(cfg: ModelConfig, params: Tree, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    return lm_head_logits(cfg, params["embed"], params.get("lm_head"), x)


def _apply_layer(cfg: ModelConfig, kind: str, ffn: str, lp: Tree, x: torch.Tensor,
                 positions: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer of the training forward: (new x, aux loss or None)."""
    if kind in ("attn", "mla"):
        fn = attn.attn_apply if kind == "attn" else attn.mla_apply
        return _attn_layer(cfg, ffn, lp, x, lambda h: fn(cfg, lp["attn"], h, positions), False)
    if kind == "mamba2":
        return x + ssm.mamba2_apply(cfg, lp["mixer"], apply_norm(cfg, lp["ln1"], x)), None
    if kind == "rwkv6":
        x = x + ssm.rwkv6_time_mix(cfg, lp["tm"], apply_norm(cfg, lp["ln1"], x))[0]
        return x + ssm.rwkv6_channel_mix(cfg, lp["tm"], apply_norm(cfg, lp["ln2"], x))[0], None
    raise ValueError(kind)


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The counterpart of ``dots_with_no_batch_dims_saveable``: the outputs of
    2-D matrix products are saved (the projections), batched products
    (``bmm``, ``baddbmm``: the experts', whose groups the reference vmaps)
    and everything else are recomputed.  The router's fp32 product is a 2-D
    ``mm`` here, saved where the reference's vmap recomputes it: the same
    values either way.  The kernels' ctypes launches write into outputs
    from ``torch.empty``, which is recomputed too, so the recompute
    launches each kernel again."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def backbone(cfg: ModelConfig, params: Tree, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens -> final hidden states (B,S,D) and the layers' summed aux loss."""
    # the reference pins the batch after the embedding, before RWKV's ln0:
    # a row-wise norm, the same placement either way
    x = constrain_batch(_embed(cfg, params, batch["tokens"], batch))
    positions = positions_for(cfg, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    remat_kw = dict(use_reentrant=False)
    if cfg.remat_policy == "dots":
        remat_kw["context_fn"] = partial(create_selective_checkpoint_contexts, _dots_policy)
    groups = layer_groups(cfg)
    for gi, _, kind, ffn, lp in _walk(cfg, params):
        if cfg.remat and torch.is_grad_enabled():
            x, aux = remat(_apply_layer, cfg, kind, ffn, lp, x, positions, **remat_kw)
        else:
            x, aux = _apply_layer(cfg, kind, ffn, lp, x, positions)
        if groups[gi].kind != "shared_attn":
            x = constrain_batch(x)  # as the reference pins each stacked layer's output
        if aux is not None:
            aux_total = aux_total + aux
    x = apply_norm(cfg, params["final_norm"], x)
    return x, aux_total


def loss(cfg: ModelConfig, params: Tree, batch: Dict) -> torch.Tensor:
    h, aux = backbone(cfg, params, batch)
    xent = chunked_softmax_xent(cfg, params["embed"], params.get("lm_head"), h,
                                batch["labels"], batch.get("loss_mask"))
    return xent + aux


def logits_fn(cfg: ModelConfig, params: Tree, batch: Dict) -> torch.Tensor:
    """Full-sequence logits (B,S,V) — tiny shapes and tests only."""
    h, _ = backbone(cfg, params, batch)
    return lm_head_logits(cfg, params["embed"], params.get("lm_head"), h)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------
def _cache_one(cfg: ModelConfig, kind: str, batch: int, max_len: int,
               dt: torch.dtype, device: torch.device) -> Tree:
    if kind in ("attn", "shared_attn"):
        return attn.attn_init_cache(cfg, batch, max_len, dt, device)
    if kind == "mla":
        return attn.mla_init_cache(cfg, batch, max_len, dt, device)
    if kind == "mamba2":
        return ssm.mamba2_init_state(cfg, batch, dt, device)
    if kind == "rwkv6":
        return ssm.rwkv6_init_state(cfg, batch, dt, device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device, mesh=None) -> List[Tree]:
    """One stacked cache tree per layer group, each leaf (count, ...).
    With a ``mesh`` the leaves are DTensors, the batch dim over the data
    axes (its ``constrain_batch`` placement), zeros made shard by shard."""
    dt = cfg.compute_tdtype()
    out = []
    for g in layer_groups(cfg):
        one = _cache_one(cfg, g.kind, batch, max_len, dt, torch.device("meta"))
        out.append({k: batch_zeros((g.count, *v.shape), v.dtype, device, mesh, 1)
                    for k, v in one.items()})
    return out


def _write(cache: Tree, state: Tree) -> None:
    for k, v in state.items():
        if v.shape != cache[k].shape:  # copy_ would broadcast a short state
            raise ValueError(f"cache {k!r} is {tuple(cache[k].shape)}, "
                             f"state is {tuple(v.shape)}")
        cache[k].copy_(v)


def _prefill_layer(cfg: ModelConfig, kind: str, ffn: str, lp: Tree, x: torch.Tensor,
                   positions: torch.Tensor, c: Tree) -> torch.Tensor:
    """One layer over the prompt; writes its cache ``c`` in place."""
    if kind in ("attn", "mla"):
        fn = attn.attn_prefill if kind == "attn" else attn.mla_prefill
        return _attn_layer(cfg, ffn, lp, x, lambda h: fn(cfg, lp["attn"], h, positions, c)[0],
                           True)[0]
    if kind == "mamba2":
        out, state = ssm.mamba2_prefill(cfg, lp["mixer"], apply_norm(cfg, lp["ln1"], x))
        _write(c, state)
        return x + out
    if kind == "rwkv6":
        tm, (last_x, s) = ssm.rwkv6_time_mix(cfg, lp["tm"], apply_norm(cfg, lp["ln1"], x))
        x = x + tm
        cm, cm_last = ssm.rwkv6_channel_mix(cfg, lp["tm"], apply_norm(cfg, lp["ln2"], x))
        _write(c, {"tm_x": last_x, "wkv": s, "cm_x": cm_last})
        return x + cm
    raise ValueError(kind)


def _decode_layer(cfg: ModelConfig, kind: str, ffn: str, lp: Tree, x: torch.Tensor,
                  pos: torch.Tensor, c: Tree) -> torch.Tensor:
    """One layer for one token; writes its cache ``c`` in place."""
    if kind in ("attn", "mla"):
        fn = attn.attn_decode if kind == "attn" else attn.mla_decode
        return _attn_layer(cfg, ffn, lp, x, lambda h: fn(cfg, lp["attn"], h, pos, c)[0],
                           True)[0]
    if kind == "mamba2":
        out, state = ssm.mamba2_decode(cfg, lp["mixer"], apply_norm(cfg, lp["ln1"], x), c)
        _write(c, state)
        return x + out
    if kind == "rwkv6":
        tm, state = ssm.rwkv6_decode(cfg, lp["tm"], apply_norm(cfg, lp["ln1"], x), c)
        x = x + tm
        cm, state = ssm.rwkv6_channel_decode(cfg, lp["tm"], apply_norm(cfg, lp["ln2"], x),
                                             state)
        _write(c, state)
        return x + cm
    raise ValueError(kind)


def prefill(cfg: ModelConfig, params: Tree, batch: Dict,
            max_len: int) -> tuple:
    """Process a prompt of S tokens; return last-position logits and the
    primed cache (max_len slots)."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens, batch)
    positions = positions_for(cfg, batch)
    mesh = active_mesh() if is_dtensor(tokens) else None
    cache = init_cache(cfg, tokens.shape[0], max_len, tokens.device, mesh)
    for gi, i, kind, ffn, lp in _walk(cfg, params):
        x = _prefill_layer(cfg, kind, ffn, lp, x, positions, _index(cache[gi], i))
    return _head(cfg, params, x[:, -1]), cache


def decode_step(cfg: ModelConfig, params: Tree, cache: List[Tree],
                token: torch.Tensor, pos: torch.Tensor) -> tuple:
    """One decode step.  token: (B,), pos: (B,) int32 -> logits (B, V)."""
    x = _embed(cfg, params, token[:, None])
    for gi, i, kind, ffn, lp in _walk(cfg, params):
        x = _decode_layer(cfg, kind, ffn, lp, x, pos, _index(cache[gi], i))
    return _head(cfg, params, x[:, 0]), cache
