"""Reusable fault-injection + invariant-checking harness
(repro_torch.testing).

Everything here is production-importable (no pytest dependency): the
chip smoke drive and the launcher use the same fault toolkit the tests
assert on.
"""

from .faults import (FlakyPredictor, KVFaultError, PredictorUnavailable,
                     VirtualClock, assert_engine_quiesced, inject_kv_fault,
                     scale_distribution)
from .tolerance import (GRAD_REL_BAR, GRAD_REL_BAR_MOE, GRAD_REL_BAR_SSM,
                        SSD_PLAIN_GRAD_BAR, TokenMismatch,
                        assert_tokens_close, grad_rel_errors)

__all__ = ["FlakyPredictor", "GRAD_REL_BAR", "GRAD_REL_BAR_MOE",
           "GRAD_REL_BAR_SSM", "SSD_PLAIN_GRAD_BAR",
           "KVFaultError", "PredictorUnavailable", "TokenMismatch",
           "VirtualClock", "assert_engine_quiesced", "assert_tokens_close",
           "grad_rel_errors", "inject_kv_fault", "scale_distribution"]
