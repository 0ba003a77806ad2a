"""Zamba2 1.2B — Mamba2 backbone with a shared attention block applied
every 6th layer [arXiv:2411.15242].  (The per-invocation LoRA deltas on
the shared block are omitted, as in the reference package.)"""

from repro_torch.models.config import MambaConfig, ModelConfig


def _pattern(n_layers: int, every: int = 6):
    return tuple(
        "shared_attn" if (i + 1) % every == 0 else "mamba2"
        for i in range(n_layers)
    )


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        vocab_size=32000, d_model=2048, n_layers=38,
        n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192,
        block_pattern=_pattern(38),
        mamba=MambaConfig(d_state=64, d_conv=4, expand=2, headdim=64, ngroups=1),
        mlp_act="silu", rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        vocab_size=512, d_model=128, n_layers=4,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
        block_pattern=("mamba2", "shared_attn", "mamba2", "shared_attn"),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2, headdim=32, ngroups=1),
        mlp_act="silu",
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
