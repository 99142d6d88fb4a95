from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
    get_arch,
    list_archs,
    register_arch,
    smoke_config,
)

__all__ = [
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "applicable_shapes",
    "get_arch",
    "list_archs",
    "register_arch",
    "smoke_config",
]
