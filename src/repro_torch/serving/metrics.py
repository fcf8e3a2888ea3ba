"""Engine-level serving metrics (TTFT / ITL / throughput accounting).

Swap IO is accounted in *modeled* seconds through the SAME
``ServiceModel.swap_time`` / block-table math the simulator charges, so
the real engine and the discrete-event simulator report preemption cost
from one model (asserted in tests/test_serving_engine.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["EngineMetrics"]


def _pct(values: np.ndarray, q: float) -> float:
    return float(np.quantile(values, q))


@dataclass
class EngineMetrics:
    prefills: int = 0            # completed prefill passes (swap-ins skip)
    prefill_chunks: int = 0      # chunk forwards run (== prefills if atomic)
    prefill_tokens: int = 0      # true (unpadded) prompt tokens prefilled
    prefill_tokens_reused: int = 0  # prompt tokens adopted from the prefix
                                 # index instead of being re-prefilled
                                 # (copy-on-write sharing; 0 when off)
    decode_iterations: int = 0   # device decode forwards executed
    decode_tokens: int = 0       # tokens actually sampled (masked lanes
                                 # and post-finish fori_loop steps excluded)
    fused_steps: int = 0         # fused jitted (multi-)step calls issued;
                                 # each is ONE device dispatch + ONE
                                 # device->host bookkeeping transfer
    completed: int = 0
    preemptions: int = 0
    forced_evictions: int = 0    # capacity-forced (decode-growth) evictions
    grow_failures: int = 0       # KVCacheManager.grow() returned False
    swap_outs: int = 0
    swap_ins: int = 0
    swapped_out_tokens: int = 0
    swapped_in_tokens: int = 0
    modeled_swap_s: float = 0.0  # ServiceModel.swap_time over swap events
    # ----- overload / failure accounting (goodput != throughput) -----
    aborted: int = 0             # requests ended by abort() (any reason)
    shed: int = 0                # gateway load-shed verdicts (terminal)
    retries: int = 0             # gateway re-admission attempts
    timeout_aborts: int = 0      # TTFT/TTLT deadline-triggered aborts
    wasted_tokens: int = 0       # tokens decoded for requests that were
                                 # later aborted / shed / timed out
    swap_in_faults: int = 0      # unexpected swap_in failures that fell
                                 # back to recompute (pool had room)
    # per-tenant rolling calibration table (coverage@q, CRPS, observed/
    # predicted length) — refreshed by the engine on every completion
    # from the scheduler's CalibrationMonitor; empty when untracked
    calibration: dict = field(default_factory=dict)

    def _failure_counters(self) -> dict:
        return {
            "aborted": self.aborted,
            "shed": self.shed,
            "retries": self.retries,
            "timeout_aborts": self.timeout_aborts,
            "wasted_tokens": self.wasted_tokens,
            "goodput_tokens": self.decode_tokens - self.wasted_tokens,
        }

    def summary(self, requests) -> dict:
        done = [r for r in requests
                if np.isfinite(getattr(r, "ttlt", np.nan))]
        if not done:
            return {"completed": 0, "calibration": self.calibration,
                    **self._failure_counters()}
        ttft = np.array([r.ttft for r in done])
        ttlt = np.array([r.ttlt for r in done])
        gen = np.array([r.generated for r in done], np.float64)
        # inter-token latency: decode-phase spacing, excluding the first
        # token (that is TTFT's job); single-token requests contribute 0
        itl = (ttlt - ttft) / np.maximum(gen - 1, 1)
        arrivals = np.array([r.arrival for r in done])
        span = float((arrivals + ttlt).max() - arrivals.min())
        return {
            "completed": len(done),
            "mean_ttft_s": float(ttft.mean()),
            "p50_ttft_s": _pct(ttft, 0.50),
            "p95_ttft_s": _pct(ttft, 0.95),
            "p99_ttft_s": _pct(ttft, 0.99),
            "mean_ttlt_s": float(ttlt.mean()),
            "mean_itl_s": float(itl.mean()),
            "p50_itl_s": _pct(itl, 0.50),
            "p95_itl_s": _pct(itl, 0.95),
            "p99_itl_s": _pct(itl, 0.99),
            "output_tokens_per_s": float(gen.sum() / max(span, 1e-9)),
            "mean_output_len": float(gen.mean()),
            "prefills": self.prefills,
            "prefill_chunks": self.prefill_chunks,
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_reused": self.prefill_tokens_reused,
            "decode_iterations": self.decode_iterations,
            "decode_tokens": self.decode_tokens,
            "fused_steps": self.fused_steps,
            "preemptions": self.preemptions,
            "forced_evictions": self.forced_evictions,
            "grow_failures": self.grow_failures,
            "swap_outs": self.swap_outs,
            "swap_ins": self.swap_ins,
            "modeled_swap_s": self.modeled_swap_s,
            "calibration": self.calibration,
            **self._failure_counters(),
        }
