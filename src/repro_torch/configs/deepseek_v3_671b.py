"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8 MoE, MTP [arXiv:2412.19437; hf].

61L d_model=7168 128H (MLA) expert_d_ff=2048 vocab=129280; first 3 layers dense
(d_ff=18432 per the public config); MTP depth 1.
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig

ARCH_ID = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=18432,                      # dense-FFN layers (first 3)
        vocab_size=129280,
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048,
                      n_shared=1, d_shared=2048, first_dense_layers=3,
                      capacity_factor=1.25),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        mtp_depth=1,
        rope_theta=10000.0,
        source="arXiv:2412.19437",
    )
