"""Whisper-tiny — enc-dec audio transformer; conv frontend stubbed to
precomputed frame embeddings [arXiv:2212.04356]."""

from repro_torch.models.config import EncDecConfig, ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        vocab_size=51865, d_model=384, n_layers=4,
        n_heads=6, n_kv_heads=6, d_ff=1536,
        mlp_act="gelu_mlp", norm="layernorm", qkv_bias=True,
        rope_type="none",
        enc_dec=EncDecConfig(n_enc_layers=4, n_audio_ctx=1500),
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        vocab_size=512, d_model=64, n_layers=2,
        n_heads=4, n_kv_heads=4, d_ff=128,
        mlp_act="gelu_mlp", norm="layernorm", qkv_bias=True,
        rope_type="none",
        enc_dec=EncDecConfig(n_enc_layers=2, n_audio_ctx=64),
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=32, remat=False,
    )
