"""Architecture configuration dataclasses (PyTorch port).

A copy of the reference package's ``ModelConfig`` and its sub-configs, so
the port imports nothing of that package.  The fields and their defaults
are the reference's, with three differences:

* ``param_tdtype``/``compute_tdtype`` return ``torch.dtype``s;
* ``attn_impl`` and ``scan_impl`` default to ``"auto"``: the hand-written
  CUDA kernels for tensors on the card, the plain ``ref`` path for tensors
  on the CPU (:func:`repro_torch.kernels.ops._resolve`);
* DeepSeek-V2's published settings, which the reference lacks: the YaRN
  fields (``yarn_*``) and the group-limited routing of ``MoEConfig``
  (``n_group``, ``topk_group``, ``routed_scaling``, ``norm_topk``).  Their
  defaults compute what the reference computes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    serve_capacity_factor: float = 3.0
    aux_loss_weight: float = 1e-3
    group_tokens: int = 1024
    map_chunk_groups: int = 4096
    dropless: bool = False
    # DeepSeek-V2's group-limited routing: the experts in ``n_group`` groups
    # of consecutive ids, a token's top_k taken within its ``topk_group``
    # best groups (a group scored by its best expert); with ``norm_topk``
    # false the gates are the probabilities times ``routed_scaling``, not
    # renormalised.  The defaults are the plain top-k with renormalised gates.
    n_group: int = 1
    topk_group: int = 1
    routed_scaling: float = 1.0
    norm_topk: bool = True


@dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    ngroups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.headdim


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 4
    n_audio_ctx: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    head_dim: int = 0  # 0 => d_model // n_heads
    block_pattern: Tuple[str, ...] = ()
    mlp_act: str = "silu"
    qkv_bias: bool = False
    parallel_block: bool = False
    tie_embeddings: bool = False
    scale_embed: bool = False
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    norm_unit_offset: bool = False
    rope_theta: float = 10000.0
    rope_type: str = "standard"
    # rope_type "yarn" (DeepSeek-V2's rope_scaling): the scale factor, the
    # positions the model was pre-trained at, the correction range's
    # rotations and the two attention-temperature coefficients
    yarn_factor: float = 1.0
    yarn_original_max_len: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    enc_dec: Optional[EncDecConfig] = None
    visual_stub: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    vocab_round: int = 256
    loss_chunk: int = 1024
    remat: bool = True
    remat_policy: str = "nothing"
    attn_impl: str = "auto"  # kernels/ops impl selector: ref|cuda|auto
    scan_impl: str = "auto"  # kernels/ops impl selector: ref|cuda|auto
    sharding_profile: str = "fsdp"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        r = self.vocab_round
        return (self.vocab_size + r - 1) // r * r

    @property
    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern:
            if len(self.block_pattern) != self.n_layers:
                raise ValueError("block_pattern length must equal n_layers")
            return self.block_pattern
        return ("attn",) * self.n_layers

    def param_tdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.param_dtype]

    def compute_tdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.compute_dtype]


_PORTED_BLOCKS = ("attn", "mla", "mamba2", "shared_attn", "rwkv6")
# the sub-config each block kind reads
_BLOCK_CONFIGS = {"mla": "mla", "mamba2": "mamba", "rwkv6": "rwkv"}


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a setting the port does not know,
    and ``ValueError`` for a block kind without its sub-config.

    The port covers every branch of the reference: the dense GQA/MQA
    decoders (RMSNorm or LayerNorm, the unit-offset norm, scaled and tied
    embeddings, qkv biases, parallel blocks, standard RoPE, M-RoPE with a
    stubbed visual frontend or no position encoding, gated SiLU or GELU
    MLPs and the plain two-layer GELU MLP, a softcapped head), multi-head
    latent attention (DeepSeek-V2's MLA), mixture-of-experts FFNs (routed
    and shared experts, leading dense layers), Mamba2 blocks with a shared
    attention block (Zamba2), RWKV6 blocks and the Whisper
    encoder-decoder (``enc_dec``), under either remat policy (``"dots"``;
    any other name means nothing saved, as in the reference).  Beyond the
    reference it runs DeepSeek-V2 as published: YaRN rope (``rope_type``
    ``"yarn"``, on MLA blocks only) and group-limited routing with scaled
    gates (``MoEConfig.n_group`` and the fields after it).  A name
    outside these (a block kind, ``rope_type``, ``norm`` or ``mlp_act``)
    is refused here, so that a config never silently runs a different
    model.
    """
    unknown = sorted(set(cfg.blocks) - set(_PORTED_BLOCKS))
    missing = [name for name, on in (
        ("block kinds " + ",".join(unknown), bool(unknown)),
        ("rope_type=" + cfg.rope_type,
         cfg.rope_type not in ("standard", "mrope", "none", "yarn")),
        ("rope_type=yarn outside MLA blocks",
         cfg.rope_type == "yarn" and set(cfg.blocks) != {"mla"}),
        ("norm=" + cfg.norm, cfg.norm not in ("rmsnorm", "layernorm")),
        ("mlp_act=" + cfg.mlp_act,
         cfg.mlp_act not in ("silu", "swiglu", "gelu", "geglu", "gelu_mlp")),
    ) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not supported: {', '.join(missing)}")
    for kind, sub in _BLOCK_CONFIGS.items():
        if kind in cfg.blocks and getattr(cfg, sub) is None:
            raise ValueError(f"{cfg.name}: {kind} blocks need cfg.{sub}")
    m = cfg.moe
    if m is not None and (m.num_experts % m.n_group
                          or m.topk_group * (m.num_experts // m.n_group) < m.top_k):
        raise ValueError(f"{cfg.name}: {m.num_experts} experts in {m.n_group} groups, "
                         f"{m.topk_group} of them kept, cannot give top_k {m.top_k}")
