"""RWKV6 (Finch) 7B — attention-free, data-dependent decay
[arXiv:2404.05892]."""

from repro_torch.models.config import ModelConfig, RWKVConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        vocab_size=65536, d_model=4096, n_layers=32,
        n_heads=64, n_kv_heads=64, d_ff=14336,
        block_pattern=("rwkv6",) * 32,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
        rope_type="none",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke",
        vocab_size=512, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=4, d_ff=256,
        block_pattern=("rwkv6",) * 2,
        rwkv=RWKVConfig(head_dim=32, decay_lora=16, mix_lora=8),
        rope_type="none",
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
