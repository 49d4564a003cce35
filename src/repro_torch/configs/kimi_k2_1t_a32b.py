"""kimi-k2-1t-a32b — trillion-param MoE (paper-table) [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8, per the assignment table) expert_d_ff=2048
vocab=163840, MoE 384 routed top-8 + 1 shared, first layer dense.
NOTE: the public K2 uses MLA; the assignment table specifies GQA kv=8 and we
follow the assignment exactly (see docs/DESIGN.md §5).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

ARCH_ID = "kimi-k2-1t-a32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=18432,                      # dense-FFN first layer
        vocab_size=163840,
        moe=MoEConfig(n_experts=384, top_k=8, d_expert=2048,
                      n_shared=1, d_shared=2048, first_dense_layers=1,
                      capacity_factor=1.25),
        rope_theta=50000.0,
        source="arXiv:2501.kimi2 (assignment table)",
    )
