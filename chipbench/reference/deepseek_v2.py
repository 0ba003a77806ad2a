"""Plain reference of DeepSeek-V2 as published (deepseek-ai/DeepSeek-V2,
config.json and modeling_deepseek.py): the first layer dense, then MLA and
a MoE of routed plus shared experts, with YaRN rope and group-limited
routing.

Plain PyTorch, float32 with TF32 off (:func:`setup`); it imports nothing of
the program.  It reads the weights the benchmark made, in the layout of the
program's parameter tree, as :mod:`chipbench.reference.moe_lm` does, whose
layout, precision and block helpers it shares (``rmsnorm``, ``attend``,
``mlp``, ``Prec``, ``logits``, ``with_layers``).  The weights are drawn as
DeepSeek-V2 initialises them, but for the router (:func:`init_scale`).

The model, as its configuration states it:

* pre-norm residual blocks, RMSNorm (eps from the config), SiLU-gated MLPs;
* MLA: q = q_up(norm(q_down x)); the latent ckv = norm(kv_down x)[:kv_lora]
  and the shared rope key from the rest; per-head keys [ckv k_up, rope key],
  values ckv v_up;
* YaRN on the rope dims (the published ``rope_scaling``, module constants
  here, since the benchmark's sizes do not carry them): inverse frequencies
  f_i = theta^(-2i/d) below the correction range, f_i / factor above it, a
  linear ramp between; the range is where the pre-training length held
  beta_fast and beta_slow rotations; cos and sin times
  m(mscale) / m(mscale_all_dim), m(a) = 0.1 a ln(factor) + 1; the softmax
  scale (qk_nope + qk_rope)^-1/2 times m(mscale_all_dim)^2;
* routed experts: softmax over the fp32 router's logits; the experts in
  ``n_group`` groups of consecutive ids, each scored by its best
  probability; a token's top-k taken among the experts of its
  ``topk_group`` best groups; the gates are those probabilities times
  ``routed_scaling`` (``norm_topk`` false, as published) or renormalised
  to sum 1; every assignment computed (dropless: the token groups the
  benchmark hands in, and their capacities, are not read); shared experts
  are one MLP of width d_expert x num_shared on every token;
* the untied head over the first ``vocab_size`` rows.

Departures from the published model:

* the rope dims are rotated split-half; the published checkpoint stores
  them interleaved and its code permutes them before ``rotate_half``.  With
  seeded weights that is a fixed permutation of the rope columns of
  ``q_up`` and ``kv_down``, so the same model;
* no auxiliary loss: the reference serves only (the published sequence-level
  loss has no coefficient in the config; :func:`forward`'s aux is 0);
* bf16 weights, the router and the head read as float32 (the weights the
  benchmark made), where the published checkpoint is bf16 throughout;
* the router drawn at a quarter of the published 0.006.  At 0.006 the 160
  probabilities of a token lie within about 1% of each other around the
  sixth place, so a bf16 program routes 5-12% of the tokens of every MoE
  layer otherwise than this float32 reference does, each such token's state
  then some 10% away; a prompt's last token so caught moves its first token
  as far as the reference in float8 does.  At a quarter the gates are
  nearer 16/160 each and such a token moves a few times less (PERF.md).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from chipbench.reference.moe_lm import (Prec, Tensors, attend, capacity, contiguous_groups,
                                        logits, mlp, rmsnorm, setup, with_layers)

__all__ = ["Prec", "capacity", "contiguous_groups", "forward", "init_scale", "logits",
           "setup", "with_layers"]

#: the published ``rope_scaling`` (type "yarn")
YARN_FACTOR = 40.0
YARN_ORIGINAL_MAX_LEN = 4096
YARN_BETA_FAST = 32.0
YARN_BETA_SLOW = 1.0
YARN_MSCALE = 0.707
YARN_MSCALE_ALL_DIM = 0.707

#: DeepSeek-V2's initialisation (arXiv:2405.04434, section 3.1.2): every
#: learnable parameter drawn at this standard deviation
INIT_STD = 0.006
#: the router's draw, a quarter of :data:`INIT_STD` (a departure, below)
ROUTER_STD = INIT_STD / 4


def init_scale(path: Sequence, shape: Tuple[int, ...]) -> Optional[float]:
    """The standard deviation of a weight's seeded draw: 0.006 for every
    matrix but the router (the token table, the projections, the experts,
    the head), as the published model was initialised; the router at
    :data:`ROUTER_STD`; norm scales are ones (None)."""
    if path[-1] == "scale":
        return None
    return ROUTER_STD if path[-1] == "router" else INIT_STD


def yarn_m(a: float) -> float:
    """YaRN's attention temperature at the published factor."""
    return 0.1 * a * math.log(YARN_FACTOR) + 1.0


def yarn_range(dim: int, theta: float) -> Tuple[int, int]:
    """(low, high): the frequency indices where the pre-training length
    held beta_fast and beta_slow rotations, floored and ceiled into
    [0, dim - 1]."""
    def corr(rotations: float) -> float:
        return dim * math.log(YARN_ORIGINAL_MAX_LEN / (rotations * 2 * math.pi)) \
            / (2 * math.log(theta))
    return max(math.floor(corr(YARN_BETA_FAST)), 0), min(math.ceil(corr(YARN_BETA_SLOW)), dim - 1)


def yarn_inv_freq(dim: int, theta: float, device=None) -> torch.Tensor:
    """The dim / 2 inverse frequencies, from the closed form in float64."""
    low, high = yarn_range(dim, theta)
    i = torch.arange(dim // 2, dtype=torch.float64)
    f = theta ** (-2.0 * i / dim)
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    return (f * (1 - ramp) + f / YARN_FACTOR * ramp).to(torch.float32).to(device)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """YaRN rope, split-half; x (B, S, H, D), pos (B, S)."""
    ang = pos.float()[..., None] * yarn_inv_freq(x.shape[-1], theta, x.device)
    gain = yarn_m(YARN_MSCALE) / yarn_m(YARN_MSCALE_ALL_DIM)
    cos, sin = torch.cos(ang)[:, :, None] * gain, torch.sin(ang)[:, :, None] * gain
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softmax_scale(ms) -> float:
    m = ms.mla
    return (m["qk_nope"] + m["qk_rope"]) ** -0.5 * yarn_m(YARN_MSCALE_ALL_DIM) ** 2


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
    del qf, q_pe
    kk = torch.cat([k_nope, kpe.expand(B, S, H, rp)], -1)
    del k_nope
    o = attend(qq, kk, v, softmax_scale(ms), pr)
    del qq, kk, v
    return pr.mm(o.reshape(B, S, H * vh), p["wo"].reshape(H * vh, D))


def route(mo: dict, probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs (N, E) -> the gates and experts (N, K) of group-limited routing."""
    N, E = probs.shape
    n_group, topk_group = mo.get("n_group", 1), mo.get("topk_group", 1)
    per = E // n_group
    group_best = probs.view(N, n_group, per).max(-1).values
    chosen = torch.topk(group_best, topk_group, dim=-1).indices
    allowed = torch.zeros(N, n_group, dtype=torch.bool, device=probs.device)
    allowed.scatter_(1, chosen, True)
    allowed = allowed.repeat_interleave(per, dim=1)
    gate_w, gate_i = torch.topk(probs.masked_fill(~allowed, 0.0), mo["top_k"], dim=-1)
    if mo.get("norm_topk", True):
        gate_w = gate_w / gate_w.sum(-1, keepdim=True)
    else:
        gate_w = gate_w * mo.get("routed_scaling", 1.0)
    return gate_w, gate_i


def moe(ms, p: Tensors, x: torch.Tensor, pr: Prec) -> torch.Tensor:
    """x (N, D) -> y (N, D): every assignment through its expert."""
    mo = ms.moe
    probs = torch.softmax(pr.mm(x, p["router"]), dim=-1)
    gate_w, gate_i = route(mo, probs)
    y = torch.zeros_like(x)
    for e in range(mo["num_experts"]):
        rows, ks = torch.nonzero(gate_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        h = F.silu(pr.mm(xe, p["wi"][e])) * pr.mm(xe, p["wg"][e])
        y = y.index_add(0, rows, pr.mm(h, p["wo"][e]) * gate_w[rows, ks, None])
    return y + mlp(p["shared"], x, pr)


def layer(ms, lp: Tensors, x: torch.Tensor, pos: torch.Tensor, pr: Prec,
          cap: Optional[dict] = None) -> torch.Tensor:
    B, S, D = x.shape
    x = x + mla(ms, lp["attn"], rmsnorm(x, lp["ln1"]["scale"], ms.norm_eps), pos, pr, cap)
    h = rmsnorm(x, lp["ln2"]["scale"], ms.norm_eps)
    if "router" in lp["ffn"]:
        return x + moe(ms, lp["ffn"], h.reshape(B * S, D), pr).view(B, S, D)
    return x + mlp(lp["ffn"], h, pr)


def forward(ms, params: Tensors, tokens: torch.Tensor, groups: Sequence, pr: Prec,
            caps: Optional[List[dict]] = None, remat: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> final normed hidden states (B, S, D) and an aux loss
    of 0.  ``groups`` (the capacity dispatch's token groups) is not read:
    the published model drops no assignment.  ``caps``: a list that
    receives each layer's ckv and kpe in layer order.  ``remat`` is
    accepted for the callers' signature; nothing is differentiated here."""
    B, S = tokens.shape
    x = params["embed"]["tok"][tokens].float()
    pos = torch.arange(S, device=tokens.device)[None].expand(B, S)
    for lp in params["layer_list"]:
        cap = {} if caps is not None else None
        x = layer(ms, lp, x, pos, pr, cap)
        if caps is not None:
            caps.append(cap)
    return (rmsnorm(x, params["final_norm"]["scale"], ms.norm_eps),
            torch.zeros((), device=tokens.device))
