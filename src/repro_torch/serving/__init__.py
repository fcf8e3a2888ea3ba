"""Paged continuous-batching serving of the port: engine, gateway, KV
manager, requests, metrics."""

from .engine import EngineStallError, ServingEngine
from .gateway import Gateway, GatewayConfig, Verdict
from .kv_cache import KVCacheManager
from .metrics import EngineMetrics
from .request import RequestState, ServeRequest

__all__ = ["EngineStallError", "ServingEngine", "Gateway", "GatewayConfig",
           "Verdict", "KVCacheManager", "EngineMetrics", "RequestState",
           "ServeRequest"]
