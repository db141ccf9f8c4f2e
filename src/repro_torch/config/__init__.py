from repro_torch.config.base import (
    SHAPES,
    FederationConfig,
    ModelConfig,
    ShapeConfig,
    TrainConfig,
    get_config,
    get_shape,
    list_configs,
    register,
)

__all__ = [
    "FederationConfig",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "TrainConfig",
    "get_config",
    "get_shape",
    "list_configs",
    "register",
]
