from repro_torch.configs.base import (
    MeCeFOConfig, ModelConfig, ShapeConfig, TrainConfig, get_config, reduced, register,
)

__all__ = ["MeCeFOConfig", "ModelConfig", "ShapeConfig", "TrainConfig", "get_config",
           "reduced", "register"]
