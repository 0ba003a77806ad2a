"""Granite-MoE 3B-a800m — 40 routed experts top-8, GQA kv=8
[hf:ibm-granite/granite-3.0-3b-a800m family; the reference's dims].

The reference's config exactly: the HF checkpoint's embedding, residual,
attention and logits multipliers are not in it, so they are not here.
About 3.375 B parameters at full size: 100.7 M a layer (94.4 M of them in
the experts), 75.9 M each in the embedding and the untied head.
"""

from repro_torch.models.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        vocab_size=49155, d_model=1536, n_layers=32,
        n_heads=24, n_kv_heads=8, head_dim=64, d_ff=512,
        moe=MoEConfig(num_experts=40, top_k=8, d_expert=512,
                      capacity_factor=1.05, group_tokens=256),
        mlp_act="silu", rope_theta=10000.0,
        remat_policy="dots",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke",
        vocab_size=512, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64, capacity_factor=2.0, dropless=True),
        mlp_act="silu",
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
