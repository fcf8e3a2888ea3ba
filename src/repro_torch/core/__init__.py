"""SageSched core: the paper's contribution as a composable library.

Public API:
    PromptEmbedder, HistoryStore                      (Sec. 3.1 substrate)
    SemanticHistoryPredictor + ablation predictors    (Sec. 3.1 / 4.3.1)
    ResourceBoundCost + ablation cost models          (Sec. 3.2 / 4.3.2)
    gittins_index / gittins_index_batch               (Sec. 3.3 math)
    make_policy: fcfs/fastserve/ssjf/ltr/trail/mean/gittins/sagesched/hedged
    Scheduler: the Fig. 3 workflow facade
    CalibrationMonitor / truncate_rows / prediction_loss  (drift robustness)
"""

from .backends import (BACKEND_NAMES, BatchView, NumpyPriorityBackend,
                       CudaPriorityBackend, PriorityBackend,
                       make_priority_backend)
from .cost_model import (CostDistribution, CostModel, EncDecCost, HybridCost,
                         LinearCost, OutputLengthCost, OverallLengthCost,
                         ResourceBoundCost, bucketize_support,
                         eviction_scores, make_cost_model)
from .embedding import PromptEmbedder
from .gittins import (gittins_index, gittins_index_batch, mean_index,
                      mean_index_batch)
from .history import HistoryRecord, HistoryStore
from .policies import POLICY_NAMES, HedgedPolicy, Policy, make_policy
from .predictor import (LengthDistribution, LengthHistoryPredictor,
                        OraclePredictor, PointPredictor, Predictor,
                        ProxyModelPredictor, SemanticHistoryPredictor,
                        empirical_distribution)
from .robust import CalibrationMonitor, crps, prediction_loss, truncate_rows
from .scheduler import BatchState, ScheduledRequest, Scheduler

__all__ = [
    "CostDistribution", "CostModel", "EncDecCost", "HybridCost", "LinearCost",
    "OutputLengthCost", "OverallLengthCost", "ResourceBoundCost",
    "bucketize_support", "eviction_scores", "make_cost_model",
    "PromptEmbedder",
    "gittins_index", "gittins_index_batch", "mean_index", "mean_index_batch",
    "BACKEND_NAMES", "BatchView", "NumpyPriorityBackend",
    "CudaPriorityBackend", "PriorityBackend", "make_priority_backend",
    "HistoryRecord", "HistoryStore",
    "POLICY_NAMES", "HedgedPolicy", "Policy", "make_policy",
    "LengthDistribution",
    "LengthHistoryPredictor", "OraclePredictor", "PointPredictor",
    "Predictor", "ProxyModelPredictor", "SemanticHistoryPredictor",
    "empirical_distribution", "BatchState", "ScheduledRequest",
    "Scheduler",
    "CalibrationMonitor", "crps", "prediction_loss", "truncate_rows",
]
