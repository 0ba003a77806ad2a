"""TinyLlama 1.1B — llama2-architecture dense transformer [arXiv:2401.02385]."""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b",
        vocab_size=32000, d_model=2048, n_layers=22,
        n_heads=32, n_kv_heads=4, d_ff=5632,
        mlp_act="silu", rope_theta=10000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke",
        vocab_size=512, d_model=128, n_layers=2,
        n_heads=8, n_kv_heads=2, d_ff=352,
        mlp_act="silu", rope_theta=10000.0,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
