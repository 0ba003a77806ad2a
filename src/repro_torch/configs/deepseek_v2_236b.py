"""DeepSeek-V2 236B — MLA (kv_lora 512) + fine-grained MoE:
160 routed experts top-6 + 2 shared, first layer dense [arXiv:2405.04434].

The reference's config exactly.  About 236 B parameters at full size:
3.97 B a MoE layer (3.775 B of them in the routed experts, 149 M in the
MLA projections, 47 M in the shared experts), 0.34 B in the dense first
layer, 0.52 B each in the embedding and the untied head.
"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        vocab_size=102400, d_model=5120, n_layers=60,
        n_heads=128, n_kv_heads=128, d_ff=12288,
        block_pattern=("mla",) * 60,
        mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                      v_head=128),
        moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536, num_shared=2,
                      first_dense_layers=1, dense_d_ff=12288,
                      capacity_factor=1.0),
        mlp_act="silu", rope_theta=10000.0,
        sharding_profile="tp",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-smoke",
        vocab_size=512, d_model=128, n_layers=2,
        n_heads=4, n_kv_heads=4, d_ff=256,
        block_pattern=("mla",) * 2,
        mla=MLAConfig(q_lora=64, kv_lora=32, qk_nope=16, qk_rope=16, v_head=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=64, num_shared=1,
                      first_dense_layers=1, dense_d_ff=256,
                      capacity_factor=2.0, dropless=True),
        mlp_act="silu",
        param_dtype="float32", compute_dtype="float32",
        loss_chunk=64, remat=False,
    )
