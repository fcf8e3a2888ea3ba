"""Assigned architecture configs + input shapes (see each module's citation).

Usage:  from repro_torch.configs import get_config, ARCH_IDS, get_shape, SHAPE_IDS
"""

from .registry import (ARCH_IDS, SHAPE_IDS, InputShape, get_config,
                       get_shape, iter_configs)

__all__ = ["ARCH_IDS", "SHAPE_IDS", "InputShape", "get_config", "get_shape",
           "iter_configs"]
