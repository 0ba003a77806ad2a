"""Plain reference of the two MoE decoder LMs: granite-moe (GQA attention)
and DeepSeek-V2 (multi-head latent attention), each layer's FFN dense, or
routed experts under the capacity dispatch plus shared experts.

Plain PyTorch, float32 with TF32 off (:func:`setup`); it imports nothing of
the program.  It reads the weights the benchmark made, in the layout of the
program's parameter tree: ``layers`` is a list of runs of identical layers,
each leaf stacked over the run's layers.  Layer by layer, weights are
converted to float32 where they are used, so that the reference fits beside
the bf16 tree.

The model, as its configuration states it:

* pre-norm residual blocks, RMSNorm (eps from the config), SiLU-gated MLPs;
* GQA: q, k, v projections, split-half RoPE (theta from the config) on q
  and k, head h reads KV head h // (H / KV), softmax scale hd^-1/2;
* MLA: q = q_up(norm(q_down x)); the latent ckv = norm(kv_down x)[:kv_lora]
  and the shared rope key from the rest; per-head keys [ckv k_up, rope key],
  values ckv v_up, scale (qk_nope + qk_rope)^-1/2;
* routed experts: softmax over the fp32 router's logits, the top-k gates
  renormalised to sum 1; each token group's assignments (token-major,
  k-minor) take a position in their expert's buffer, and those at or past
  the capacity C = max(1, int(T k cf / E)) are dropped; a kept assignment
  adds its gate times its expert's SiLU MLP; shared experts are one MLP of
  width d_expert x num_shared on every token;
* the untied head over the first ``vocab_size`` rows; the training loss is
  the mean next-token cross-entropy plus each MoE layer's Switch load
  balance loss (E * w * sum_e f_e P_e, the mean over the layer's groups).

``precision="fp8"`` is the control: every product's two operands rounded
to float8 e4m3 with a per-tensor scale (amax / 448) before the float32
product.  ``precision="bf16"`` is the one below the configurations'
fp32 head and router: every product's operands and result rounded to
bfloat16 (the head and the router's included), float32 accumulation.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Tensors = Dict[str, Any]
FP8_MAX = 448.0


def setup() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_scale(path: Sequence[Any], shape: Tuple[int, ...]) -> Optional[float]:
    """The standard deviation of a weight's seeded draw, by its place in the
    program's tree: norm scales are ones (None); the token table 0.02;
    every product's weight 1 / sqrt(fan-in)."""
    name = path[-1]
    if name == "scale":
        return None
    if path[0] == "embed":
        return 0.02
    if path[0] == "lm_head":
        return shape[-1] ** -0.5
    if "ffn" in path and len(shape) == 4:       # routed experts (L, E, in, out)
        return shape[2] ** -0.5
    if tuple(path[-2:]) == ("attn", "wo"):
        return (shape[1] * shape[2]) ** -0.5    # (L, H, hd, D)
    return shape[1] ** -0.5                     # (L, in, ...)


# ---------------------------------------------------------------------------
# layout and precision
# ---------------------------------------------------------------------------
def layers_of(layers: List[Tensors]) -> List[Tensors]:
    """Per-layer dicts (views) of the stacked runs, in layer order."""
    out = []
    for run in layers:
        first = run
        while isinstance(first, dict):
            first = next(iter(first.values()))
        for i in range(first.shape[0]):
            out.append(_index(run, i))
    return out


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32;
    the gradient passes through unrounded (straight through)."""
    d = x.detach()
    scale = d.abs().amax().clamp_min(1e-30) / FP8_MAX
    return x + ((d / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale - d)


def qb(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in float32 (straight through)."""
    d = x.detach()
    return x + (d.to(torch.bfloat16).float() - d)


class Prec:
    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8", "bf16"):
            raise ValueError(precision)
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.float(), b.float()
        if self.precision == "fp8":
            return q8(a) @ q8(b)
        if self.precision == "bf16":
            return qb(qb(a) @ qb(b))
        return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half RoPE; x (B, S, H, D), pos (B, S)."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = pos.float()[..., None] * freqs
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
           pr: Prec, budget: int = 1 << 29) -> torch.Tensor:
    """Causal softmax attention, row by row and in chunks of heads; q
    (B, S, H, d), k (B, S, KV, d), v (B, S, KV, dv) -> (B, S, H, dv)."""
    B, S, H, _ = q.shape
    G = H // k.shape[2]
    hc = max(1, min(H, budget // (4 * S * S)))
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    rows = []
    for b in range(B):
        chunks = []
        for h0 in range(0, H, hc):
            idx = torch.arange(h0, min(H, h0 + hc), device=q.device) // G
            qh = q[b, :, h0:h0 + hc].transpose(0, 1)
            kh = k[b][:, idx].transpose(0, 1)
            vh = v[b][:, idx].transpose(0, 1)
            s = pr.mm(qh, kh.transpose(1, 2)) * scale
            p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
            chunks.append(pr.mm(p, vh).transpose(0, 1))
        rows.append(torch.cat(chunks, dim=1))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def gqa(ms, p: Tensors, x: torch.Tensor, pos: torch.Tensor, pr: Prec,
        cap: Optional[dict]) -> torch.Tensor:
    B, S, D = x.shape
    H, KV, hd = ms.n_heads, ms.n_kv_heads, ms.hd
    q = pr.mm(x, p["wq"].reshape(D, H * hd)).view(B, S, H, hd)
    k = pr.mm(x, p["wk"].reshape(D, KV * hd)).view(B, S, KV, hd)
    v = pr.mm(x, p["wv"].reshape(D, KV * hd)).view(B, S, KV, hd)
    q, k = rope(q, pos, ms.rope_theta), rope(k, pos, ms.rope_theta)
    if cap is not None:
        cap["k"], cap["v"] = k.detach(), v.detach()
    o = attend(q, k, v, hd ** -0.5, pr)
    return pr.mm(o.reshape(B, S, H * hd), p["wo"].reshape(H * hd, D))


def mla(ms, p: Tensors, x: torch.Tensor, pos: torch.Tensor, pr: Prec,
        cap: Optional[dict]) -> torch.Tensor:
    m = ms.mla
    B, S, D = x.shape
    H, nope, rp, kvl, vh = ms.n_heads, m["qk_nope"], m["qk_rope"], m["kv_lora"], m["v_head"]
    cq = rmsnorm(pr.mm(x, p["q_down"]), p["q_norm"]["scale"], ms.norm_eps)
    qf = pr.mm(cq, p["q_up"].reshape(m["q_lora"], H * (nope + rp))).view(B, S, H, nope + rp)
    kvf = pr.mm(x, p["kv_down"])
    ckv = rmsnorm(kvf[..., :kvl], p["kv_norm"]["scale"], ms.norm_eps)
    kpe = rope(kvf[..., None, kvl:], pos, ms.rope_theta)
    if cap is not None:
        cap["ckv"], cap["kpe"] = ckv.detach(), kpe[:, :, 0].detach()
    q_pe = rope(qf[..., nope:], pos, ms.rope_theta)
    k_nope = pr.mm(ckv, p["k_up"].reshape(kvl, H * nope)).view(B, S, H, nope)
    v = pr.mm(ckv, p["v_up"].reshape(kvl, H * vh)).view(B, S, H, vh)
    qq = torch.cat([qf[..., :nope], q_pe], -1)
    kk = torch.cat([k_nope, kpe.expand(B, S, H, rp)], -1)
    o = attend(qq, kk, v, (nope + rp) ** -0.5, pr)
    return pr.mm(o.reshape(B, S, H * vh), p["wo"].reshape(H * vh, D))


def mlp(p: Tensors, x: torch.Tensor, pr: Prec) -> torch.Tensor:
    return pr.mm(F.silu(pr.mm(x, p["wi"])) * pr.mm(x, p["wg"]), p["wo"])


def capacity(T: int, top_k: int, cf: float, E: int) -> int:
    return max(1, int(T * top_k * cf / E))


def moe(ms, p: Tensors, x: torch.Tensor, groups: Sequence[Tuple[torch.Tensor, int]],
        pr: Prec) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D) -> (y (N, D), load-balance loss).  ``groups``: (idx (G, T)
    into the N tokens, capacity C) pairs that cover every token once."""
    mo = ms.moe
    E, K = mo["num_experts"], mo["top_k"]
    N = x.shape[0]
    probs = torch.softmax(pr.mm(x, p["router"]), dim=-1)
    gate_w, gate_i = torch.topk(probs, K, dim=-1, sorted=True)
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.zeros(N, K, dtype=torch.bool, device=x.device)
    aux = []
    with torch.no_grad():
        for idx, C in groups:
            G, T = idx.shape
            gi = gate_i[idx]                                        # (G, T, K)
            onehot = F.one_hot(gi.reshape(G, T * K), E)
            pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1).view(G, T, K)
            keep[idx] = pos < C
    for idx, C in groups:
        f = F.one_hot(gate_i[idx], E).sum(-2).float().mean(-2)     # (G, E)
        aux.append(((probs[idx].mean(-2) * f).sum(-1) * E * mo["aux_loss_weight"]))
    aux = torch.cat(aux).mean()
    y = torch.zeros_like(x)
    for e in range(E):
        rows, ks = torch.nonzero((gate_i == e) & keep, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(pr.mm(xe, p["wi"][e])) * pr.mm(xe, p["wg"][e])
        y = y.index_add(0, rows, pr.mm(h, p["wo"][e]) * gate_w[rows, ks, None])
    if mo.get("num_shared"):
        y = y + mlp(p["shared"], x, pr)
    return y, aux


def layer(ms, lp: Tensors, x: torch.Tensor, pos: torch.Tensor, groups, pr: Prec,
          cap: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    B, S, D = x.shape
    mix = mla if "q_down" in lp["attn"] else gqa
    x = x + mix(ms, lp["attn"], rmsnorm(x, lp["ln1"]["scale"], ms.norm_eps), pos, pr, cap)
    h = rmsnorm(x, lp["ln2"]["scale"], ms.norm_eps)
    if "router" in lp["ffn"]:
        y, aux = moe(ms, lp["ffn"], h.reshape(B * S, D), groups, pr)
        return x + y.view(B, S, D), aux
    return x + mlp(lp["ffn"], h, pr), torch.zeros((), device=x.device)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------
def contiguous_groups(n: int, group_tokens: int, top_k: int, cf: float,
                      E: int, device) -> List[Tuple[torch.Tensor, int]]:
    """The dispatch of one call over n tokens in their flat (row-major)
    order: groups of ``group_tokens`` (the gcd with n where it does not
    divide it), each with its own capacity."""
    gt = min(group_tokens, n)
    if n % gt:
        gt = math.gcd(n, gt)
    idx = torch.arange(n, device=device).view(n // gt, gt)
    return [(idx, capacity(gt, top_k, cf, E))]


def forward(ms, params: Tensors, tokens: torch.Tensor, groups, pr: Prec,
            caps: Optional[List[dict]] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> final normed hidden states (B, S, D) and the summed
    load-balance loss.  ``caps``: a list that receives each layer's cache
    quantities (k, v or ckv, kpe) in layer order."""
    B, S = tokens.shape
    x = params["embed"]["tok"][tokens].float()
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    aux = torch.zeros((), device=tokens.device)
    for lp in params["layer_list"]:
        cap = {} if caps is not None else None
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(lambda xx, lp=lp: layer(ms, lp, xx, pos, groups, pr), x,
                              use_reentrant=False)
        else:
            x, a = layer(ms, lp, x, pos, groups, pr, cap)
        if caps is not None:
            caps.append(cap)
        aux = aux + a
    return rmsnorm(x, params["final_norm"]["scale"], ms.norm_eps), aux


def logits(ms, params: Tensors, h: torch.Tensor, pr: Prec) -> torch.Tensor:
    """Final hidden states (..., D) -> fp32 logits over the vocabulary."""
    return pr.mm(h, params["lm_head"][:ms.vocab_size].t())


def with_layers(params: Tensors) -> Tensors:
    """The program-layout tree with its per-layer views added."""
    return dict(params, layer_list=layers_of(params["layers"]))


def loss(ms, params: Tensors, tokens: torch.Tensor, labels: torch.Tensor, groups,
         pr: Prec, chunk: int = 1024) -> torch.Tensor:
    h, aux = forward(ms, params, tokens, groups, pr, remat=True)
    B, S, _ = h.shape
    total = torch.zeros((), device=h.device)
    for i in range(0, S, chunk):
        def part(hh, lab):
            lg = logits(ms, params, hh, pr)
            return (torch.logsumexp(lg, -1) - lg.gather(-1, lab[..., None])[..., 0]).sum()
        total = total + checkpoint(part, h[:, i:i + chunk], labels[:, i:i + chunk],
                                   use_reentrant=False)
    return total / (B * S) + aux
