"""stablelm-1.6b — dense [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "stablelm-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100352,
        rope_theta=10000.0,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
