"""Discrete-event serving simulator (paper Sec. 4 evaluation vehicle)."""

from .cluster import (ClusterResult, ClusterScheduler, CostAwareRouter,
                      JoinShortestWorkRouter, NodeKill, NodeSchedulerView,
                      NodeSlow, Router, ROUTER_NAMES, make_router,
                      measure_scheduler_overhead, simulate_cluster)
from .service_model import (NodeSpec, ScaledServiceModel, ServiceModel,
                            a40_llama8b, h800_qwen32b, tpu_v5e_pod8_32b)
from .simulator import NodeSimulator, RequestMetrics, SimResult, simulate
from .workload import (DATASET_NAMES, DatasetProfile, SemanticCluster,
                       SimRequest, generate_session_workload,
                       generate_workload, make_profile)

__all__ = [
    "ClusterResult", "ClusterScheduler", "CostAwareRouter",
    "JoinShortestWorkRouter", "NodeSchedulerView", "Router", "ROUTER_NAMES",
    "make_router", "measure_scheduler_overhead", "simulate_cluster",
    "NodeKill", "NodeSlow", "NodeSpec", "ScaledServiceModel",
    "ServiceModel", "a40_llama8b", "h800_qwen32b",
    "tpu_v5e_pod8_32b", "NodeSimulator", "RequestMetrics",
    "SimResult", "simulate", "DATASET_NAMES", "DatasetProfile",
    "SemanticCluster", "SimRequest", "generate_session_workload",
    "generate_workload", "make_profile",
]
