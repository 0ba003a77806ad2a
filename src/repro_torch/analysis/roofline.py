"""Roofline model of one NVIDIA H100 SXM (the port's card), twin of the
reference's ``analysis/roofline.py``.

    compute term    = FLOPs / peak FLOP/s
    memory term     = HBM bytes / HBM bytes/s
    collective term = collective bytes / link bytes/s

Every input is *per device*, so each term is a per-device quantity over a
per-card rate.  The dominant term is the step-time lower bound.  A term
whose input was not counted (``None``: a single process issues no
collectives, ``analysis/cost.py``) is absent, not zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM, from NVIDIA's datasheet (dense rates, no sparsity,
    at the full 700 W power limit): the card's one record."""

    peak_flops: float = 989e12     # bf16 dense FLOP/s
    hbm_bw: float = 3.35e12        # HBM3 bytes/s
    link_bw: float = 450e9         # NVLink 4 bytes/s one way (900 GB/s both ways)
    hbm_bytes: float = 80e9        # HBM capacity, bytes


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: Optional[float]  # None: collectives not counted
    dominant: str
    bound_s: float                 # max of the terms = step-time lower bound
    model_flops_per_dev: Optional[float] = None
    useful_ratio: Optional[float] = None  # MODEL_FLOPS / counted FLOPs

    def to_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "model_flops_per_dev": self.model_flops_per_dev,
            "useful_ratio": self.useful_ratio,
        }


def roofline(flops_per_dev: float, hbm_bytes_per_dev: float,
             coll_bytes_per_dev: Optional[float], hw: HW = HW(),
             model_flops_per_dev: Optional[float] = None) -> RooflineTerms:
    c = flops_per_dev / hw.peak_flops
    m = hbm_bytes_per_dev / hw.hbm_bw
    l = None if coll_bytes_per_dev is None else coll_bytes_per_dev / hw.link_bw
    terms = {"compute": c, "memory": m}
    if l is not None:
        terms["collective"] = l
    dom = max(terms, key=terms.get)
    return RooflineTerms(
        compute_s=c, memory_s=m, collective_s=l, dominant=dom,
        bound_s=terms[dom],
        model_flops_per_dev=model_flops_per_dev,
        useful_ratio=(model_flops_per_dev / flops_per_dev
                      if model_flops_per_dev and flops_per_dev else None),
    )


def roofline_from_report(report: Dict, hw: HW = HW(),
                         model_flops_per_dev: Optional[float] = None) -> RooflineTerms:
    """Build terms from a dry-run JSON report (its ``hlo``-keyed counts)."""
    h = report["hlo"]
    return roofline(h["dot_flops"], h["dot_bytes"], h["collective_bytes"],
                    hw, model_flops_per_dev)


def model_flops(cfg, shape, mode: str) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*D_tokens (train) / 2*N_active*D
    (prefill) / 2*N_active per token (decode), plus attention terms.

    N_active counts embedding-free active params (MoE: top-k + shared
    experts only).
    """
    import numpy as np

    D = cfg.d_model
    L = cfg.n_layers
    # per-layer active params (rough standard accounting)
    n_active = 0.0
    for i, kind in enumerate(cfg.blocks):
        if kind in ("attn", "shared_attn"):
            hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
            n_active += D * hd * (H + 2 * KV) + H * hd * D
        elif kind == "mla":
            m = cfg.mla
            n_active += (D * m.q_lora + m.q_lora * cfg.n_heads * (m.qk_nope + m.qk_rope)
                         + D * (m.kv_lora + m.qk_rope)
                         + m.kv_lora * cfg.n_heads * (m.qk_nope + m.v_head)
                         + cfg.n_heads * m.v_head * D)
        elif kind == "mamba2":
            mc = cfg.mamba
            Din = mc.d_inner(D)
            n_active += D * (2 * Din + 2 * mc.ngroups * mc.d_state
                             + mc.n_heads(D)) + Din * D
        elif kind == "rwkv6":
            n_active += 4 * D * D + D * D + D * cfg.d_ff + cfg.d_ff * D + D * D
        # ffn
        if kind in ("attn", "shared_attn", "mla") and cfg.moe is not None:
            mm = cfg.moe
            if i >= mm.first_dense_layers:
                n_active += 3 * D * mm.d_expert * (mm.top_k + mm.num_shared)
            else:
                n_active += 3 * D * (mm.dense_d_ff or cfg.d_ff)
        elif kind in ("attn", "shared_attn"):
            mult = 2 if cfg.mlp_act == "gelu_mlp" else 3
            n_active += mult * D * cfg.d_ff
    if cfg.enc_dec is not None:
        # encoder layers + decoder cross-attention
        n_active += cfg.enc_dec.n_enc_layers * (4 * D * D + 2 * D * cfg.d_ff)
        n_active += L * 4 * D * D  # cross attn
    n_active += D * cfg.padded_vocab  # lm head

    tokens = shape.global_batch * (shape.seq_len if mode != "decode" else 1)
    if mode == "train":
        flops = 6.0 * n_active * tokens
        # causal attention scores+values: 6 * (2 * S^2/2 * H * hd) per seq
        attn_layers = sum(1 for k in cfg.blocks if k in ("attn", "shared_attn", "mla"))
        hd_eff = (cfg.mla.qk_nope + cfg.mla.qk_rope + cfg.mla.v_head) / 2 if cfg.mla \
            else cfg.hd
        flops += 6.0 * attn_layers * shape.global_batch * \
            (shape.seq_len ** 2) * cfg.n_heads * hd_eff
    elif mode == "prefill":
        flops = 2.0 * n_active * tokens
        attn_layers = sum(1 for k in cfg.blocks if k in ("attn", "shared_attn", "mla"))
        hd_eff = (cfg.mla.qk_nope + cfg.mla.qk_rope + cfg.mla.v_head) / 2 if cfg.mla \
            else cfg.hd
        flops += 2.0 * attn_layers * shape.global_batch * \
            (shape.seq_len ** 2) * cfg.n_heads * hd_eff
    else:  # decode: one token, attention over the cache
        flops = 2.0 * n_active * tokens
        attn_layers = sum(1 for k in cfg.blocks if k in ("attn", "shared_attn", "mla"))
        hd_eff = (cfg.mla.qk_nope + cfg.mla.qk_rope + cfg.mla.v_head) / 2 if cfg.mla \
            else cfg.hd
        flops += 2.0 * attn_layers * shape.global_batch * 2 * \
            shape.seq_len * cfg.n_heads * hd_eff
    return flops
