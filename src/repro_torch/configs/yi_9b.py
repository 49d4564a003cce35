"""yi-9b — llama-arch GQA [arXiv:2403.04652; hf].

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "yi-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=48,
        d_model=4096,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=10000.0,
        source="arXiv:2403.04652",
    )
