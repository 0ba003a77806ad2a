"""Shared layers: init helpers, norms, RoPE / M-RoPE, embeddings, LM head.

Plain functions on tensors, twins of the reference package's
``models/common.py``.  Initialisers draw from an explicit
``torch.Generator`` on the generator's device, with the reference's
distributions (the numbers differ: the two frameworks' generators differ);
under ``with torch.device("meta")`` they make shapes only (``init_device``).

The activation constraints (``constrain_dims`` and its two shorthands) pin
a DTensor's dims to the axes of the mesh that ``launch.mesh.mesh_context``
made active, by the reference's rules; on a plain tensor, or with no mesh
active, they return their argument itself, so the meshless path is the one
it was before they existed.
"""

from __future__ import annotations

import math
from contextvars import ContextVar, copy_context
from typing import Any, Dict, Optional, Sequence, Tuple

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
    x = (_lookup_on_shards(emb["tok"], tokens) if is_dtensor(tokens)
         else emb["tok"][tokens]).to(cfg.compute_tdtype())
    if cfg.scale_embed:
        # the reference rounds sqrt(d_model) to x's dtype first (bf16:
        # sqrt(3072) = 55.43 becomes 55.5); the product of that scalar and
        # x, computed in fp32 and rounded once, is the reference's
        x = x * float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return x


def _lookup_on_shards(table: torch.Tensor, tokens) -> torch.Tensor:
    """``table[tokens]`` over a mesh: each rank looks its own token rows up
    in the whole table, as the meshless path does.  DTensor's rules for a
    lookup fail in torch 2.11 (indices split over two mesh dims; the
    backward's ``index_put``) and in 2.13 (a table split over "model"
    under tp).  A split table (the dry-run's) is gathered whole; its
    gradient is a partial sum over the axes that split the tokens."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = tokens.device_mesh
    rows = [p if p.is_shard(0) else Replicate() for p in tokens.placements]
    if not is_dtensor(table):
        table = DTensor.from_local(table, mesh, [Replicate()] * mesh.ndim, run_check=False)
    whole = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard(0) else Replicate() for p in rows])
    return DTensor.from_local(whole[tokens.redistribute(mesh, rows).to_local()], mesh, rows,
                              run_check=False)


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
    logits = constrain_dims(_softcap(cfg, hh.float() @ wf.t()),  # (B,C,V) float32
                            {0: "dp", 2: "model"})
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)  # (B,C)
    if is_dtensor(logits):
        # DTensor's gather over a vocab split over "model" fails to reduce
        # its masked partial result; the label's logit is also the sum of
        # the row with every other entry zeroed, exactly
        hit = torch.arange(logits.shape[-1], device=logits.device) == labels[..., None]
        lab = torch.where(hit, logits, 0.0).sum(-1)
    else:
        lab = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - lab) * mask).sum()


def remat(fn, *args, **kwargs):
    """``torch.utils.checkpoint(fn, *args, **kwargs)`` whose recompute sees
    the caller's active mesh and sharding profile.  Autograd runs a CUDA
    backward on its own device thread, where the caller's ``contextvars``
    are not set, so the recompute would apply no constraint and read the
    default profile; ``fn`` runs under a copy of the forward's context
    both times."""
    ctx = copy_context()
    return checkpoint(lambda *a: ctx.copy().run(fn, *a), *args, **kwargs)


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
        total = total + remat(_xent_chunk, cfg, h[:, i:i + C], wf, labels[:, i:i + C],
                              mask[:, i:i + C], use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# activation constraints over the active mesh
# ---------------------------------------------------------------------------
#: the mesh that ``launch.mesh.mesh_context`` made active (None: no mesh) and
#: the sharding profile, "tp" or "fsdp"
_MESH: ContextVar[Any] = ContextVar("repro_torch_mesh", default=None)
_PROFILE: ContextVar[str] = ContextVar("repro_torch_profile", default="tp")


def set_sharding_profile(profile: str) -> None:
    """"tp": the model axis shards hidden activation dims (Megatron-style).
    "fsdp": the model axis is one more data axis; constraints on "model"
    are no-ops and batch dims may shard over it.  Sets the profile of the
    current context (``mesh_context`` restores the outer one on exit)."""
    assert profile in ("tp", "fsdp")
    _PROFILE.set(profile)


def get_sharding_profile() -> str:
    return _PROFILE.get()


def active_mesh():
    """The ``DeviceMesh`` of the enclosing ``mesh_context``, or None."""
    return _MESH.get()


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _dp_axes(mesh) -> tuple:
    names = ["pod", "data"]
    if _PROFILE.get() == "fsdp":
        names.append("model")
    return tuple(a for a in names if a in mesh.mesh_dim_names)


def constrain_spec(mesh, shape: Sequence[int],
                   assignments: Dict[int, str]) -> Optional[Tuple]:
    """The reference's ``PartitionSpec`` for ``assignments`` on a tensor of
    ``shape``, as a tuple with one entry a dim (None, an axis name or a
    tuple of them), or None where it pins nothing.

    ``assignments`` maps dim -> role, role in {"dp", "model"}.  "dp" is all
    data axes, then fewer (the fallback chain); "model" is dropped under
    the fsdp profile.  A dim whose size the axes do not divide is skipped,
    and each axis is used once, in the order of ``assignments``."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    spec = [None] * len(shape)
    used = set()
    for dim, role in assignments.items():
        d = dim % len(shape)
        if role == "dp":
            ax = _dp_axes(mesh)
            candidates = [ax[:k] for k in range(len(ax), 0, -1)]
        else:
            if _PROFILE.get() == "fsdp" or role not in sizes:
                continue
            candidates = [(role,)]
        for names in candidates:
            if not names or any(a in used for a in names):
                continue
            size = math.prod(sizes[a] for a in names)
            if size > 1 and shape[d] % size == 0:
                spec[d] = names if len(names) > 1 else names[0]
                used.update(names)
                break
    return None if all(s is None for s in spec) else tuple(spec)


def spec_placements(spec: Sequence, mesh) -> list:
    """DTensor placements of a spec on a ``DeviceMesh``: for each mesh
    dimension ``Shard(d)`` if the spec puts that axis on tensor dim ``d``,
    else ``Replicate()``.  A tuple entry shards one tensor dimension over
    several mesh dimensions, in mesh order (the spec's tuples list the data
    axes in mesh order, major first)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, names in enumerate(spec):
        for a in (() if names is None else (names,) if isinstance(names, str) else names):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


def constrain_dims(x: torch.Tensor, assignments: Dict[int, str],
                   free: Sequence[int] = ()) -> torch.Tensor:
    """Pin activation dims to mesh axes: a DTensor is redistributed to the
    placements of :func:`constrain_spec` (replicated on every axis the spec
    leaves out), the eager counterpart of ``with_sharding_constraint``.
    The dims in ``free`` are left unconstrained, as the reference leaves a
    ``vmap``ped dim: an axis the spec does not use keeps its split of one
    of them.  A plain tensor, no active mesh, or a spec that pins nothing
    returns ``x`` itself."""
    mesh = _MESH.get()
    if mesh is None or not is_dtensor(x):
        return x
    spec = constrain_spec(mesh, x.shape, assignments)
    if spec is None:
        return x
    want = spec_placements(spec, mesh)
    if free:
        free = {d % x.ndim for d in free}
        want = [q if p.is_replicate() and q.is_shard() and q.dim in free else p
                for p, q in zip(want, x.placements)]
    return x if tuple(x.placements) == tuple(want) else x.redistribute(mesh, want)


def zero_pad(x: torch.Tensor, pad: Sequence[int]) -> torch.Tensor:
    """``F.pad(x, pad)`` with zeros.  A DTensor is padded by concatenating
    zeros instead: DTensor's rule for ``constant_pad_nd`` in torch 2.11
    returns a spec of one placement on a mesh of two dims, which the next
    view op refuses.  The values are the same."""
    if not is_dtensor(x):
        return F.pad(x, pad)
    for i in range(len(pad) // 2):
        d = x.ndim - 1 - i
        shape = list(x.shape)

        def zeros(n):
            shape[d] = n
            return [torch.zeros(shape, dtype=x.dtype, device=x.device)] if n else []

        parts = zeros(pad[2 * i]) + [x] + zeros(pad[2 * i + 1])
        if len(parts) > 1:
            x = torch.cat(parts, dim=d)
    return x


def unflatten_last(x: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """``x.unflatten(-1, sizes)``.  A DTensor split along its last dim (a
    product with a weight the dry-run lays out by its spec) is gathered
    along it first where the split does not fall on whole rows of
    ``sizes[0]``: DTensor refuses to regroup such a split."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        d = x.ndim - 1
        n = math.prod(size for p, size in zip(x.placements, x.device_mesh.shape)
                      if p.is_shard(d))
        if sizes[0] % n:
            x = x.redistribute(x.device_mesh, [Replicate() if p.is_shard(d) else p
                                               for p in x.placements])
    return x.unflatten(-1, sizes)


def constrain_batch(x: torch.Tensor) -> torch.Tensor:
    """Pin the leading batch dim to the data axes (block-boundary anchor)."""
    return constrain_dims(x, {0: "dp"})


def constrain_hidden(x: torch.Tensor, model_dim: int = -1) -> torch.Tensor:
    """Batch on data axes + a hidden (ffn/heads/vocab) dim on "model"."""
    return constrain_dims(x, {0: "dp", model_dim: "model"})


def act_fn(name: str):
    if name in ("silu", "swiglu"):
        return F.silu
    if name in ("gelu", "geglu", "gelu_mlp"):  # the tanh GELU, as the reference's
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)
