"""Model zoo of the port (dense, SSM and hybrid decoders; encoder-decoder)."""

from .config import FAMILIES, ModelConfig
from .model import Model, build_model

__all__ = ["FAMILIES", "ModelConfig", "Model", "build_model"]
