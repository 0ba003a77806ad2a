"""The yardstick's arithmetic, frozen here so that a change to the program
cannot move it: the card's datasheet peaks, the analytic model FLOPs, the
operations and bytes of each kernel call from its shapes, the bytes a decode
step needs, and the classification of profiler events into the parts of a
MoE step.

``model_flops`` is a copy of ``repro_torch/analysis/roofline.py``'s; the
classification is a copy of ``chip_smoke.py``'s ``_moe_split``.  Both read
the sizes from a configuration's ``model`` block (:class:`Sizes`), never from
the program's own config objects.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

#: NVIDIA H100 SXM datasheet, dense rates at the full 700 W power limit
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


@dataclass(frozen=True)
class Sizes:
    """The model sizes of a configuration's ``model`` block."""

    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int
    vocab_size: int
    vocab_round: int
    blocks: Tuple[str, ...]
    mlp_act: str
    rope_theta: float
    norm_eps: float
    moe: Optional[dict]
    mla: Optional[dict]

    @classmethod
    def of(cls, model: dict) -> "Sizes":
        n = model["n_layers"]
        return cls(d_model=model["d_model"], n_layers=n, n_heads=model["n_heads"],
                   n_kv_heads=model["n_kv_heads"], d_ff=model["d_ff"],
                   head_dim=model.get("head_dim") or model["d_model"] // model["n_heads"],
                   vocab_size=model["vocab_size"], vocab_round=model.get("vocab_round", 256),
                   blocks=tuple(model.get("block_pattern") or ("attn",) * n),
                   mlp_act=model.get("mlp_act", "silu"),
                   rope_theta=float(model.get("rope_theta", 10000.0)),
                   norm_eps=float(model.get("norm_eps", 1e-6)),
                   moe=model.get("moe"), mla=model.get("mla"))

    @property
    def hd(self) -> int:
        return self.head_dim

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round
        return (self.vocab_size + r - 1) // r * r

    def ffn_kind(self, layer: int) -> str:
        if self.moe is None:
            return "mlp"
        return "moe" if layer >= self.moe.get("first_dense_layers", 0) else "dense"


def model_flops(s: Sizes, batch: int, seq_len: int, mode: str) -> float:
    """Analytic MODEL_FLOPS: 6*N_active*tokens (train), 2*N_active*tokens
    (prefill), 2*N_active a token (decode), plus attention terms; N_active
    counts embedding-free active parameters (MoE: top-k + shared experts)
    and the head.  ``seq_len`` is the cache length in decode."""
    D = s.d_model
    n_active = 0.0
    for i, kind in enumerate(s.blocks):
        if kind in ("attn", "shared_attn"):
            n_active += D * s.hd * (s.n_heads + 2 * s.n_kv_heads) + s.n_heads * s.hd * D
        elif kind == "mla":
            m = s.mla
            n_active += (D * m["q_lora"] + m["q_lora"] * s.n_heads * (m["qk_nope"] + m["qk_rope"])
                         + D * (m["kv_lora"] + m["qk_rope"])
                         + m["kv_lora"] * s.n_heads * (m["qk_nope"] + m["v_head"])
                         + s.n_heads * m["v_head"] * D)
        else:
            raise ValueError(f"model_flops: block kind {kind!r} is not counted here")
        if s.moe is not None:
            mm = s.moe
            if i >= mm.get("first_dense_layers", 0):
                n_active += 3 * D * mm["d_expert"] * (mm["top_k"] + mm.get("num_shared", 0))
            else:
                n_active += 3 * D * (mm.get("dense_d_ff") or s.d_ff)
        else:
            n_active += (2 if s.mlp_act == "gelu_mlp" else 3) * D * s.d_ff
    n_active += D * s.padded_vocab
    attn_layers = sum(1 for k in s.blocks if k in ("attn", "shared_attn", "mla"))
    hd_eff = ((s.mla["qk_nope"] + s.mla["qk_rope"] + s.mla["v_head"]) / 2 if s.mla
              else s.hd)
    if mode == "train":
        return 6.0 * n_active * batch * seq_len \
            + 6.0 * attn_layers * batch * seq_len ** 2 * s.n_heads * hd_eff
    if mode == "prefill":
        return 2.0 * n_active * batch * seq_len \
            + 2.0 * attn_layers * batch * seq_len ** 2 * s.n_heads * hd_eff
    return 2.0 * n_active * batch + 2.0 * attn_layers * batch * 2 * seq_len * s.n_heads * hd_eff


def flash_fwd_bound_s(B: int, H: int, KV: int, S: int, T: int, D: int, causal: bool,
                      elem_bytes: int = 2) -> float:
    """The least time of one flash forward call: the larger of its products'
    FLOPs (QK^T and PV over the pairs it must compute) over the bf16 peak,
    and its bytes (Q, K, V read once, O written once) over the HBM rate."""
    pairs = S * (S + 1) / 2 + (T - S) * S if causal else S * T
    flops = 4.0 * B * H * pairs * D
    nbytes = elem_bytes * (2 * B * S * H * D + 2 * B * T * KV * D)
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def _attn_weight_elems(s: Sizes, kind: str) -> int:
    D = s.d_model
    if kind == "mla":
        m = s.mla
        return (D * m["q_lora"] + m["q_lora"] + m["q_lora"] * s.n_heads * (m["qk_nope"] + m["qk_rope"])
                + D * (m["kv_lora"] + m["qk_rope"]) + m["kv_lora"]
                + m["kv_lora"] * s.n_heads * (m["qk_nope"] + m["v_head"])
                + s.n_heads * m["v_head"] * D)
    return D * s.hd * (s.n_heads + 2 * s.n_kv_heads) + s.n_heads * s.hd * D


def decode_step_bytes(s: Sizes, batch: int, cache_len: float) -> Dict[str, float]:
    """Bytes one greedy decode step over ``batch`` requests needs, each read
    once, bf16 weights: the routed experts that the step's tokens can select
    (at most min(E, batch * top_k) a layer: the benchmark has no routing of
    its own), the shared experts, the dense layers' MLPs, the attention
    weights, norms and the fp32 router, the bf16 head table, and the cache
    read (``cache_len`` positions a request)."""
    D = s.d_model
    out = {"routed": 0.0, "shared": 0.0, "dense": 0.0, "rest": 0.0, "cache": 0.0}
    for i, kind in enumerate(s.blocks):
        out["rest"] += 2 * (_attn_weight_elems(s, kind) + 2 * D)
        if kind == "mla":
            m = s.mla
            out["cache"] += 2 * batch * cache_len * (m["kv_lora"] + m["qk_rope"])
        else:
            out["cache"] += 2 * 2 * batch * cache_len * s.n_kv_heads * s.hd
        ffn = s.ffn_kind(i)
        if ffn == "moe":
            mm = s.moe
            E = mm["num_experts"]
            out["routed"] += 2 * 3 * D * mm["d_expert"] * min(E, batch * mm["top_k"])
            out["shared"] += 2 * 3 * D * mm["d_expert"] * mm.get("num_shared", 0)
            out["rest"] += 4 * D * E
        elif ffn == "dense":
            out["dense"] += 2 * 3 * D * (s.moe.get("dense_d_ff") or s.d_ff)
        else:
            out["dense"] += 2 * 3 * D * s.d_ff
    out["rest"] += 2 * D * s.padded_vocab + 2 * D
    return out


# ---------------------------------------------------------------------------
# classification of profiler events (a copy of chip_smoke.py's _moe_split)
# ---------------------------------------------------------------------------
ATTENTION_KERNEL = re.compile(r"\b(fa_fwd|decode)_(bf16|f32)\b")
FLASH_FWD_BF16 = re.compile(r"\bfa_fwd_bf16\b")


def moe_parts(averages_by_shape: List, num_experts: int, plain_bwd_attention_s: float,
              cpu_type) -> Dict[str, float]:
    """Device seconds by part of a profiled MoE run, from the aten ops that
    launch the kernels: the experts' products (``bmm`` batched over the E
    experts), the dispatch and combine (the gathers and their ``index_add_``
    backward, the slot table's 1-D ``scatter_``, the combine's ``bmm`` with
    a unit dimension), and attention (the flash and decode kernels and the
    plain attention backward).  ``averages_by_shape`` is
    ``key_averages(group_by_input_shape=True)``."""
    parts = {"moe expert products": 0.0, "moe dispatch/combine": 0.0, "attention": 0.0}
    for e in averages_by_shape:
        if e.device_type != cpu_type:
            if ATTENTION_KERNEL.search(e.key):
                parts["attention"] += e.self_device_time_total / 1e6
            continue
        shape = e.input_shapes[0] if e.input_shapes else []
        if e.key == "aten::bmm" and len(shape) == 3:
            if shape[0] == num_experts:
                parts["moe expert products"] += e.device_time_total / 1e6
            elif 1 in shape[1:]:
                parts["moe dispatch/combine"] += e.device_time_total / 1e6
        elif e.key in ("aten::index_select", "aten::index_add_") or \
                (e.key == "aten::scatter_" and len(shape) == 1):
            parts["moe dispatch/combine"] += e.device_time_total / 1e6
    parts["attention"] += plain_bwd_attention_s
    return parts


def ffn_mm_seconds(averages_by_shape: List, s: Sizes, cpu_type) -> float:
    """Device seconds of the dense and shared experts' 2-D products: the
    ``aten::mm`` calls whose weight operand is (D, F) or (F, D) for F the
    shared experts' width or a dense layer's."""
    D = s.d_model
    widths = set()
    if s.moe is not None:
        if s.moe.get("num_shared"):
            widths.add(s.moe["d_expert"] * s.moe["num_shared"])
        if s.moe.get("first_dense_layers"):
            widths.add(s.moe.get("dense_d_ff") or s.d_ff)
    total = 0.0
    for e in averages_by_shape:
        if e.device_type != cpu_type or e.key != "aten::mm" or len(e.input_shapes) < 2:
            continue
        w = list(e.input_shapes[1])
        if len(w) == 2 and any(w in ([D, f], [f, D]) for f in widths):
            total += e.device_time_total / 1e6
    return total
