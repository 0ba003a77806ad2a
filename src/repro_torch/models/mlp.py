"""Feed-forward blocks: gated MLPs (SwiGLU or GeGLU), Whisper's plain
two-layer GELU MLP and mixture-of-experts, twins of the reference's
``mlp_*`` and ``moe_*``.

The MoE layer is the reference's capacity dispatch (Switch/t5x style):
each token picks its top-k experts, its position inside an expert's buffer
is an exclusive cumulative sum over the (token, k) assignments, and
assignments at or past the capacity C are dropped.  The reference selects
with einsums against (tokens, experts, capacity) one-hots; here the same
selection is an exact gather (``index_select``) into (E, groups * C, D)
expert buffers and back, and the combine sums the gate-weighted expert
outputs in one product, as the reference's combine einsum does.  Token
groups sit on a leading axis, where the reference vmaps over them.
``dropless`` configs take the reference's exact path instead: sort the
assignments by expert and run a grouped matmul (its ``ragged_dot``).

The plain MLP (``mlp_act="gelu_mlp"``) keeps the gated MLP's tree, as the
reference does: ``wg`` is made and never read, so its gradient is zero.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import act_fn, dense_init
from .config import ModelConfig

Tensors = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# dense gated MLP
# ---------------------------------------------------------------------------
def mlp_init(cfg: ModelConfig, gen: torch.Generator,
             d_ff: Optional[int] = None) -> Tensors:
    d_ff = d_ff or cfg.d_ff
    dt = cfg.param_tdtype()
    return {
        "wi": dense_init(gen, cfg.d_model, (d_ff,), dt),   # gate proj
        "wg": dense_init(gen, cfg.d_model, (d_ff,), dt),   # up proj
        "wo": dense_init(gen, d_ff, (cfg.d_model,), dt),
    }


def mlp_apply(cfg: ModelConfig, p: Tensors, x: torch.Tensor) -> torch.Tensor:
    h = act_fn(cfg.mlp_act)(x @ p["wi"].to(x.dtype))
    if cfg.mlp_act != "gelu_mlp":  # gated; gelu_mlp is the plain 2-layer MLP (Whisper)
        h = h * (x @ p["wg"].to(x.dtype))
    return h @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# mixture of experts
# ---------------------------------------------------------------------------
def moe_init(cfg: ModelConfig, gen: torch.Generator) -> Tensors:
    """Router (D, E) in fp32 whatever the param dtype; experts ``wi``/``wg``
    (E, D, F) and ``wo`` (E, F, D) at the reference's fan-in (D, F);
    ``shared`` experts as one gated MLP of width ``d_expert * num_shared``."""
    m = cfg.moe
    dt = cfg.param_tdtype()
    D, E, Fe = cfg.d_model, m.num_experts, m.d_expert
    p = {
        "router": dense_init(gen, D, (E,), torch.float32),
        "wi": dense_init(gen, D, (E, Fe), dt).transpose(0, 1).contiguous(),
        "wg": dense_init(gen, D, (E, Fe), dt).transpose(0, 1).contiguous(),
        "wo": dense_init(gen, Fe, (E, D), dt).transpose(0, 1).contiguous(),
    }
    if m.num_shared:
        p["shared"] = mlp_init(cfg, gen, d_ff=Fe * m.num_shared)
    return p


def _router_logits(p: Tensors, x: torch.Tensor) -> torch.Tensor:
    """The reference's einsum(x, router.astype(x.dtype),
    preferred_element_type=f32): the router rounded to x's dtype, the
    logits accumulated in fp32 and never rounded to bf16 (products of bf16
    values are exact in fp32; with TF32 off only the order of the sums
    differs)."""
    return x.float() @ p["router"].to(x.dtype).float()


def _route(cfg: ModelConfig, p: Tensors,
           x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (..., T, D) -> normalised gate weights and experts (..., T, K), in
    descending order as ``lax.top_k`` gives them, and the load-balancing
    aux loss (...,)."""
    m = cfg.moe
    E = m.num_experts
    probs = torch.softmax(_router_logits(p, x), dim=-1)
    gate_w, gate_i = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch's E * sum_e f_e * P_e
    ce = F.one_hot(gate_i, E).sum(-2).float().mean(-2)
    aux = (probs.mean(-2) * ce).sum(-1) * E * m.aux_loss_weight
    return gate_w, gate_i, aux


def _slots(gate_i: torch.Tensor, E: int, C: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """gate_i (G, T, K) -> each assignment's position in its expert's buffer
    (an exclusive count over the group's assignments, t-major and k-minor)
    and whether it is kept (position below the capacity C)."""
    G, T, K = gate_i.shape
    flat = F.one_hot(gate_i.reshape(G, T * K), E)
    pos = ((flat.cumsum(1) - flat) * flat).sum(-1).view(G, T, K)
    return pos, pos < C


def _dispatch(x: torch.Tensor, slot: torch.Tensor, rows: int) -> torch.Tensor:
    """x (N, D), slot (N, K) -> the expert buffers (rows, D): row ``slot[t,
    k]`` is x[t].  Dropped assignments carry ``slot == rows``, which is
    discarded.  A row no assignment landed in (zero in the reference) holds
    x[0] here: no combine reads its output with a nonzero weight, so
    neither the values nor the gradients see it."""
    N, K = slot.shape
    src = torch.zeros(rows + 1, dtype=torch.long, device=x.device)
    src.scatter_(0, slot.reshape(-1), torch.arange(N * K, device=x.device) // K)
    return x.index_select(0, src[:-1])


def _experts(cfg: ModelConfig, p: Tensors, h: torch.Tensor) -> torch.Tensor:
    """The experts' gated MLPs over their buffers: (E, n, D) -> (E, n, D)."""
    act = act_fn(cfg.mlp_act)
    wi, wg, wo = (p[k].to(h.dtype) for k in ("wi", "wg", "wo"))
    return torch.bmm(act(torch.bmm(h, wi)) * torch.bmm(h, wg), wo)


def _combine(out: torch.Tensor, slot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out (rows, D), slot and gate weights w (N, K) -> (N, D): the sum over k
    of w[t, k] * out[slot[t, k]], the weights in out's dtype and the sum in
    one product, as the reference's combine einsum.  A dropped assignment
    (``slot == rows``) has weight 0 and reads the last row: 0 times a finite
    row adds exactly nothing, and its gradient reaches neither the row nor,
    through the kept mask, the gate."""
    N, K = slot.shape
    g = out.index_select(0, slot.reshape(-1).clamp_max(out.shape[0] - 1))
    return torch.bmm(w.to(out.dtype).reshape(N, 1, K), g.view(N, K, -1)).view(N, -1)


def _moe_capacity(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
                  cf: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over G token groups of T tokens, each with its own capacity C.
    x: (G, T, D) -> (y (G, T, D), aux (G,))."""
    m = cfg.moe
    G, T, D = x.shape
    E = m.num_experts
    C = max(1, int(T * m.top_k * cf / E))
    gate_w, gate_i, aux = _route(cfg, p, x)
    pos, keep = _slots(gate_i, E, C)
    group = torch.arange(G, device=x.device)[:, None, None]
    # rows of the (E, G, C) buffers; a dropped assignment points past the end
    slot = torch.where(keep, (gate_i * G + group) * C + pos, E * G * C).reshape(G * T, -1)
    expert_in = _dispatch(x.reshape(G * T, D), slot, E * G * C).view(E, G * C, D)
    out = _experts(cfg, p, expert_in).view(E * G * C, D)
    y = _combine(out, slot, (gate_w * keep).reshape(G * T, -1))
    return y.view(G, T, D), aux


def _moe_dropless(cfg: ModelConfig, p: Tensors,
                  x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless dispatch over all T tokens: the (t, k) assignments sorted by
    expert (stable, as ``jnp.argsort``), each expert's run of rows through
    its MLP (the reference's ``ragged_dot``), the weighted outputs added
    back.  x: (T, D) -> (y (T, D), aux scalar)."""
    m = cfg.moe
    gate_w, gate_i, aux = _route(cfg, p, x)
    flat_e = gate_i.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    tok = order // m.top_k
    xs = x[tok]
    if flat_e.is_meta:
        # a shapes-only trace (the dry-run) has no routing to read; the
        # grouped products' FLOPs and bytes do not depend on how the rows
        # split over the experts, so split them evenly
        n, E = flat_e.numel(), m.num_experts
        sizes = [n // E + (e < n % E) for e in range(E)]
    else:
        sizes = torch.bincount(flat_e, minlength=m.num_experts).tolist()
    act = act_fn(cfg.mlp_act)
    wi, wg, wo = (p[k].to(x.dtype) for k in ("wi", "wg", "wo"))
    out = torch.cat([(act(xe @ wi[e]) * (xe @ wg[e])) @ wo[e]
                     for e, xe in enumerate(xs.split(sizes))])
    w_sorted = gate_w.reshape(-1)[order].to(x.dtype)
    return torch.zeros_like(x).index_add_(0, tok, out * w_sorted[:, None]), aux


def moe_apply(cfg: ModelConfig, p: Tensors, x: torch.Tensor,
              serve: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux loss).

    Capacity dispatch over groups of ``group_tokens`` tokens (the gcd with
    B * S when that does not divide it), the aux loss the mean over the
    groups; ``serve=True`` takes the larger ``serve_capacity_factor``.
    The reference maps its vmap over chunks of ``map_chunk_groups`` groups
    when there are more, to bound its temporaries; that changes no value,
    so one batched pass over all groups stands for both of its branches.
    ``dropless`` configs take the exact sort + grouped-matmul path.
    """
    m = cfg.moe
    B, S, D = x.shape
    if m.dropless:
        y, aux = _moe_dropless(cfg, p, x.reshape(B * S, D))
    else:
        T = B * S
        gt = min(m.group_tokens, T)
        if T % gt:
            gt = math.gcd(T, gt)
        cf = m.serve_capacity_factor if serve else m.capacity_factor
        y, auxs = _moe_capacity(cfg, p, x.reshape(T // gt, gt, D), cf)
        aux = auxs.mean()
    y = y.reshape(B, S, D)
    if m.num_shared:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux


def moe_apply_dense_oracle(cfg: ModelConfig, p: Tensors, x: torch.Tensor) -> torch.Tensor:
    """Every expert on every token, weighted by the top-k gates: the tests'
    oracle (O(E) work; tiny shapes only).  No capacity, no drops; the fp32
    router unrounded, as in the reference's oracle."""
    m = cfg.moe
    B, S, D = x.shape
    act = act_fn(cfg.mlp_act)
    xf = x.reshape(B * S, D)
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gate_w, gate_i = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    w_full = torch.zeros_like(probs).scatter(-1, gate_i, gate_w)
    wi, wg, wo = (p[k].to(x.dtype) for k in ("wi", "wg", "wo"))
    h = act(torch.einsum("td,edf->etf", xf, wi)) * torch.einsum("td,edf->etf", xf, wg)
    out = torch.einsum("etf,efd->etd", h, wo)
    y = torch.einsum("te,etd->td", w_full.to(x.dtype), out).reshape(B, S, D)
    if m.num_shared:
        y = y + mlp_apply(cfg, p["shared"], x)
    return y
