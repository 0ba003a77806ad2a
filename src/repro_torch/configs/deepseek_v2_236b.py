"""DeepSeek-V2 236B — MLA (kv_lora 512) + fine-grained MoE:
160 routed experts top-6 + 2 shared, first layer dense [arXiv:2405.04434].

``full()`` is the published config.json (deepseek-ai/DeepSeek-V2): the
reference's config plus what the reference lacks, YaRN rope (factor 40
over 4096 pre-trained positions, beta_fast 32, beta_slow 1, mscale and
mscale_all_dim 0.707), group-limited routing (8 groups of 20 experts, the
top-6 within a token's best 3; gates not renormalised, times 16) and, as
its inference code, every assignment computed (the dropless dispatch).
``smoke()`` is the reference's smoke config exactly.  About 236 B
parameters at full size: 3.97 B a MoE layer (3.775 B of them in the routed
experts, 149 M in the MLA projections, 47 M in the shared experts), 0.34 B
in the dense first layer, 0.52 B each in the embedding and the untied head.
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
                      capacity_factor=1.0, dropless=True,
                      n_group=8, topk_group=3, routed_scaling=16.0, norm_topk=False),
        mlp_act="silu", rope_theta=10000.0,
        rope_type="yarn", yarn_factor=40.0, yarn_original_max_len=4096,
        yarn_beta_fast=32.0, yarn_beta_slow=1.0, yarn_mscale=0.707,
        yarn_mscale_all_dim=0.707,
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
