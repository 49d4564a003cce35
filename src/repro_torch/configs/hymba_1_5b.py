"""hymba-1.5b — hybrid parallel attention + mamba heads [arXiv:2411.13676; hf].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention (1024) everywhere except first/middle/last layers
(full attention), per the Hymba paper; every block carries a parallel SSM
branch (chunked-SSD adaptation, see docs/DESIGN.md §2).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        window=1024,
        global_layers=(0, 15, 31),
        ssm=SSMConfig(state_size=16, expand=2, head_dim=64, chunk=128),
        rope_theta=10000.0,
        source="arXiv:2411.13676",
    )
