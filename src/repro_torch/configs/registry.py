"""Architecture registry: ``--arch <id>`` lookup for all assigned configs."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

# arch-id -> module name under repro_torch.configs
_MODULES: Dict[str, str] = {
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "whisper-medium": "whisper_medium",
    "stablelm-1.6b": "stablelm_1_6b",
    "yi-9b": "yi_9b",
    "qwen2.5-32b": "qwen2_5_32b",
    "qwen2.5-14b": "qwen2_5_14b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
