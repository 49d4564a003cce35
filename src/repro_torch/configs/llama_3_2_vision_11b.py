"""llama-3.2-vision-11b — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision].

40L total = 32 self-attn + 8 gated cross-attn (every 5th), d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256. Vision tower is a STUB: ``input_specs``
provides precomputed patch embeddings (assignment rule).
"""
from repro_torch.configs.base import ModelConfig, VisionConfig

ARCH_ID = "llama-3.2-vision-11b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=32,                     # self-attn blocks; +8 cross => 40L total
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=128256,
        vision=VisionConfig(n_cross_layers=8, interval=5, n_patches=1024, d_vision=1280),
        rope_theta=500000.0,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )
