"""rwkv6-1.6b — Finch, data-dependent decay, attention-free [arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536; head_size=64 (32 heads). Implemented
with the chunked-GLA algorithm (log-space per-channel decay) — see docs/DESIGN.md §2.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

ARCH_ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        rwkv=RWKVConfig(head_size=64, decay_lora=64, gate_lora=64, chunk=128),
        source="arXiv:2404.05892",
    )
