"""Gemma 2B — GeGLU, head_dim 256, MQA (kv=1) [arXiv:2403.08295]."""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        vocab_size=256000, d_model=2048, n_layers=18,
        n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384,
        mlp_act="gelu", rope_theta=10000.0,
        norm_unit_offset=True, scale_embed=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke",
        vocab_size=512, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256,
        mlp_act="gelu", norm_unit_offset=True, scale_embed=True,
        tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
