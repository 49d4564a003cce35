from repro_torch.configs.base import (EncDecConfig, MLAConfig, MoEConfig, ModelConfig,
                                RunConfig, RWKVConfig, ShapeConfig, SSMConfig,
                                VisionConfig)
from repro_torch.configs.registry import ARCH_IDS, all_configs, get_config
from repro_torch.configs.shapes import SHAPE_NAMES, SHAPES, applicability

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig",
    "EncDecConfig", "VisionConfig", "ShapeConfig", "RunConfig",
    "ARCH_IDS", "get_config", "all_configs", "SHAPES", "SHAPE_NAMES",
    "applicability",
]
