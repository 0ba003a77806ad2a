"""Command-R 35B — parallel attention+MLP blocks, LayerNorm, no biases,
tied embeddings [hf:CohereForAI/c4ai-command-r-v01]."""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="command-r-35b",
        vocab_size=256000, d_model=8192, n_layers=40,
        n_heads=64, n_kv_heads=8, d_ff=22528,
        mlp_act="silu", rope_theta=10000.0,
        parallel_block=True, norm="layernorm", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="command-r-smoke",
        vocab_size=512, d_model=128, n_layers=2,
        n_heads=8, n_kv_heads=2, d_ff=352,
        mlp_act="silu", parallel_block=True, norm="layernorm",
        tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
