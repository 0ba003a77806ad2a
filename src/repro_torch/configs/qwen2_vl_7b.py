"""Qwen2-VL 7B — M-RoPE, qkv bias, vision frontend stubbed to precomputed
patch embeddings [arXiv:2409.12191]."""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        vocab_size=152064, d_model=3584, n_layers=28,
        n_heads=28, n_kv_heads=4, d_ff=18944,
        mlp_act="silu", rope_theta=1000000.0,
        rope_type="mrope", mrope_sections=(16, 24, 24),
        qkv_bias=True, visual_stub=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-smoke",
        vocab_size=512, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, d_ff=256,
        mlp_act="silu", rope_type="mrope", mrope_sections=(4, 6, 6),
        qkv_bias=True, visual_stub=True,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
