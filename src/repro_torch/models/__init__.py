"""Model zoo of the port (dense decoder family so far)."""

from .config import FAMILIES, ModelConfig
from .model import Model, build_model

__all__ = ["FAMILIES", "ModelConfig", "Model", "build_model"]
