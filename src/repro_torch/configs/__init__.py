"""Model configurations (port of ``repro.configs``): ``get_config(name)``."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_config, list_configs

__all__ = ["SHAPES", "ModelConfig", "ShapeConfig", "get_config", "list_configs"]
