from repro_torch.configs.base import (
    MeCeFOConfig, ModelConfig, ParallelConfig, ShapeConfig, TrainConfig, get_config, reduced,
    register,
)

__all__ = ["MeCeFOConfig", "ModelConfig", "ParallelConfig", "ShapeConfig", "TrainConfig",
           "get_config", "reduced", "register"]
