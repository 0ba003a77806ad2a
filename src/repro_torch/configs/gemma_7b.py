"""Gemma 7B — GeGLU, head_dim 256, 16 MHA heads [arXiv:2403.08295]."""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b",
        vocab_size=256000, d_model=3072, n_layers=28,
        n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576,
        mlp_act="gelu", rope_theta=10000.0,
        norm_unit_offset=True, scale_embed=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke",
        vocab_size=512, d_model=96, n_layers=2,
        n_heads=4, n_kv_heads=4, head_dim=32, d_ff=192,
        mlp_act="gelu", norm_unit_offset=True, scale_embed=True,
        tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
