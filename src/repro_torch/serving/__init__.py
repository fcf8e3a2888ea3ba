"""Paged continuous-batching serving of the port."""

from .engine import EngineStallError, ServingEngine
from .kv_cache import KVCacheManager
from .metrics import EngineMetrics
from .request import RequestState, ServeRequest

__all__ = ["EngineStallError", "ServingEngine", "KVCacheManager",
           "EngineMetrics", "RequestState", "ServeRequest"]
