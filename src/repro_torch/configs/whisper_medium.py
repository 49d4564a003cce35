"""whisper-medium — enc-dec, conv frontend (stub) [arXiv:2212.04356].

24L encoder + 24L decoder, d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865,
GELU MLPs, learned absolute positions. The conv frontend is a STUB:
``input_specs`` provides precomputed frame embeddings [B, S, d_model].
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

ARCH_ID = "whisper-medium"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="encdec",
        n_layers=24,                     # decoder layers
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        act="gelu",
        encdec=EncDecConfig(n_enc_layers=24, max_target_len=448),
        source="arXiv:2212.04356",
    )
