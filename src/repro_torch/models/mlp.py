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
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import (_dp_axes, act_fn, constrain_dims, constrain_hidden, dense_init,
                     get_sharding_profile, is_dtensor)
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
    h = constrain_hidden(h)  # ffn dim on "model": Megatron column-parallel
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
    """The experts' gated MLPs over their buffers: (E, n, D) -> (E, n, D).
    The reference's expert-parallel constraints sit on the same three
    tensors: its (E, C, D) buffers are these with the groups' slots folded
    into n.  Its groups are a ``vmap``ped dim, which its constraints leave
    free, so n keeps its split over the data axes here."""
    act = act_fn(cfg.mlp_act)
    wi, wg, wo = (_whole_but_experts(p[k].to(h.dtype)) for k in ("wi", "wg", "wo"))
    h = constrain_dims(h, {0: "model"}, free=(1,))  # EP over "model"
    f = constrain_dims(act(torch.bmm(h, wi)) * torch.bmm(h, wg),
                       {0: "model", 2: "model"}, free=(1,))  # EP, else TP in the expert
    return constrain_dims(torch.bmm(f, wo), {0: "model"}, free=(1,))


def _whole_but_experts(w: torch.Tensor) -> torch.Tensor:
    """An expert weight (E, ., .) that the dry-run lays out by its spec
    (E over "model", a feature dim over the data axes) gathered over all
    but its experts' split, as FSDP gathers a weight before its product:
    left split, DTensor would move the buffers' slots off the data axes
    onto the contracted dim and all-reduce the (E, n, D) products.  A
    weight that is whole or split by experts alone (the trainer's, the
    server's) is returned as it is."""
    if not is_dtensor(w) or all(q.is_replicate() or q.is_shard(0) for q in w.placements):
        return w
    from torch.distributed.tensor import Replicate
    return w.redistribute(w.device_mesh, [q if q.is_shard(0) else Replicate()
                                          for q in w.placements])


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


def _moe_capacity(cfg: ModelConfig, p: Tensors, x: torch.Tensor, cf: float,
                  experts: Optional[Callable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE over G token groups of T tokens, each with its own capacity C.
    x: (G, T, D) -> (y (G, T, D), aux (G,)).  ``experts(buffers, slot, w)``
    maps the (E, G * C, D) buffers, each assignment's row and its weight to
    y (G * T, D) (default: :func:`_experts` over ``p``, then
    :func:`_combine`)."""
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
    w = (gate_w * keep).reshape(G * T, -1)
    if experts is not None:
        return experts(expert_in, slot, w).view(G, T, D), aux
    y = _combine(_experts(cfg, p, expert_in).view(E * G * C, D), slot, w)
    return y.view(G, T, D), aux


def _capacity_on_shards(cfg: ModelConfig, p: Tensors, x, cf: float):
    """:func:`_moe_capacity` over a mesh: the routing, the slots, the
    dispatch and the combine read the data, which a DTensor cannot carry,
    so they run on each rank's token groups (the groups keep their split
    over the data axes, which each group's own capacity allows); the
    experts run on the buffers as a DTensor (slots split like the groups),
    under the reference's expert-parallel constraints (:func:`_experts`).

    Each rank combines what it holds of the experts' outputs along the
    other axes (:func:`_combine_local`): its own experts under EP, or its
    partial sum over a split hidden dim; the ranks' partial y then meet in
    one all-reduce of (G, T, D), as GSPMD reduces the reference's combine
    einsum, where gathering the outputs would move (E, G * C, D), top_k x
    capacity factor as many rows.  The router's gradient is a partial sum
    over the data axes."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    dp = _dp_axes(mesh)
    # the data axes that x's groups are already split over: y is split the
    # same way, so that it can be viewed back as (B, S, D)
    split, n = [], 1
    for a, size, q in zip(mesh.mesh_dim_names, mesh.shape, x.placements):
        split.append(a in dp and size > 1 and q.is_shard(0) and x.shape[0] % (n * size) == 0)
        n *= size if split[-1] else 1

    def pl(shard, other):
        return [shard if s else other for s in split]

    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=pl(Partial(), Replicate()))

    def experts(buffers, slot, w):
        d = DTensor.from_local(buffers, mesh, pl(Shard(1), Replicate()), run_check=False)
        return _combine_local(_experts(cfg, p, d), split, slot, w)

    y, aux = _moe_capacity(cfg, {"router": router},
                           x.redistribute(mesh, pl(Shard(0), Replicate())).to_local(), cf,
                           experts)
    return tuple(DTensor.from_local(t, mesh, pl(Shard(0), Replicate()), run_check=False)
                 for t in (y, aux))


def _combine_local(out, split: List[bool], slot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The combine of :func:`_capacity_on_shards` on this rank: ``out`` the
    experts' (E, R, D) outputs as a DTensor (R the rank's slots where
    ``split`` marks a data axis), ``slot`` and ``w`` this rank's (N, K) rows
    and weights -> its y (N, D), whole on every rank of the other axes.

    Along those axes each rank keeps its experts (EP: E split) or its
    partial sum (a split hidden dim), or gathers any other split; it
    combines the assignments of its experts alone, and one all-reduce over
    those axes sums the partial y.  The weights' gradient is then partial
    over the same axes, and is all-reduced in the backward."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = out.device_mesh
    E, R, D = out.shape
    want = [Shard(1) if s else q if q.is_partial() or q == Shard(0) else Replicate()
            for s, q in zip(split, out.placements)]
    local = out.redistribute(mesh, want).to_local(
        grad_placements=[Replicate() if q.is_partial() else q for q in want])
    reduced = [not s and not q.is_replicate() for s, q in zip(split, want)]
    if not any(reduced):
        return _combine(local.reshape(-1, D), slot, w)
    lo, n = 0, E  # this rank's run of experts: Shard(0) splits E in mesh order
    for i, q in enumerate(want):
        if q == Shard(0):
            n //= mesh.shape[i]
            lo += mesh.get_coordinate()[i] * n
    keep = [Shard(0) if s else Replicate() for s in split]
    w = DTensor.from_local(w, mesh, keep, run_check=False).to_local(
        grad_placements=[Partial() if r else q for r, q in zip(reduced, keep)])
    if n < E:  # masked after the reduction, so that only its own experts add to it
        w = w * ((slot >= lo * R) & (slot < (lo + n) * R))
        slot = (slot - lo * R).clamp_min(0)
    y = _combine(local.reshape(-1, D), slot, w)
    return DTensor.from_local(y, mesh, [Partial() if r else q for r, q in zip(reduced, keep)],
                              run_check=False).redistribute(mesh, keep).to_local()


def _moe_dropless(cfg: ModelConfig, p: Tensors,
                  x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless dispatch over all T tokens: the (t, k) assignments sorted by
    expert (stable, as ``jnp.argsort``), each expert's run of rows through
    its MLP (the reference's ``ragged_dot``), the weighted outputs added
    back.  x: (T, D) -> (y (T, D), aux scalar)."""
    gate_w, gate_i, aux = _route(cfg, p, x)
    if is_dtensor(x):
        return _dropless_on_shards(cfg, p, x, gate_w, gate_i), aux
    return _dropless_dispatch(cfg, p, x, gate_w, gate_i), aux


def _dropless_dispatch(cfg: ModelConfig, p: Tensors, x: torch.Tensor, gate_w: torch.Tensor,
                       gate_i: torch.Tensor) -> torch.Tensor:
    """The sort, the grouped products and the weighted sum of
    :func:`_moe_dropless` over the rows of ``x``: each token's output reads
    only its own row and its own assignments."""
    m = cfg.moe
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
    return torch.zeros_like(x).index_add_(0, tok, out * w_sorted[:, None])


def _dropless_on_shards(cfg: ModelConfig, p: Tensors, x, gate_w, gate_i):
    """:func:`_dropless_dispatch` over a mesh, on local shards: the routing
    reads the data (its sizes, its sort), which a DTensor cannot carry.

    The tokens keep their split over the data axes, which every token's
    output allows.  Under the tp profile the experts' hidden dim F is split
    over "model" where it divides (the reference's constraint of the grouped
    products' hidden, ``{1: "model"}``), so each rank's output is a partial
    sum over its slice of F.  The expert weights' gradients are partial
    sums over the data axes; the inputs' over the F split."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    dp = _dp_axes(mesh)
    T, Fe = x.shape[0], cfg.moe.d_expert
    rows, ff, n_dp, n_ff = [], [], 1, 1
    for a, n, q in zip(mesh.mesh_dim_names, mesh.shape, x.placements):
        split_rows = a in dp and n > 1 and q.is_shard(0) and T % (n_dp * n) == 0
        split_f = (not split_rows and a == "model" and get_sharding_profile() == "tp"
                   and n > 1 and Fe % (n_ff * n) == 0)
        n_dp *= n if split_rows else 1
        n_ff *= n if split_f else 1
        rows.append(split_rows)
        ff.append(split_f)

    def pl(shard, other):
        return [s if r else f if g else Replicate()
                for r, g, s, f in zip(rows, ff, shard, other)]

    def tokens(t):  # rows split on the data axes, partial grads on the F split
        want = pl([Shard(0)] * mesh.ndim, [Replicate()] * mesh.ndim)
        grad = pl([Shard(0)] * mesh.ndim, [Partial()] * mesh.ndim)
        return t.redistribute(mesh, want).to_local(grad_placements=grad)

    def weight(t, fdim):  # whole on the data axes, split on the F axes
        want = pl([Replicate()] * mesh.ndim, [Shard(fdim)] * mesh.ndim)
        grad = pl([Partial()] * mesh.ndim, [Shard(fdim)] * mesh.ndim)
        return t.redistribute(mesh, want).to_local(grad_placements=grad)

    local_p = {"wi": weight(p["wi"], 2), "wg": weight(p["wg"], 2), "wo": weight(p["wo"], 1)}
    y = _dropless_dispatch(cfg, local_p, tokens(x), tokens(gate_w), tokens(gate_i))
    return DTensor.from_local(y, mesh, pl([Shard(0)] * mesh.ndim, [Partial()] * mesh.ndim),
                              run_check=False)


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
        moe = _capacity_on_shards if is_dtensor(x) else _moe_capacity
        y, auxs = moe(cfg, p, x.reshape(T // gt, gt, D), cf)
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
