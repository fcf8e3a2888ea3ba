"""Analytic service-time model for one accelerator node.

Calibrated to the paper's Sec. 3.2 measurements (Fig. 5):

  * decode iteration time is **linear in the accumulated sequence length**
    of the batch (per-step attention reads the whole KVCache), plus a
    batch-size term (FFN/GEMM work per token) plus a fixed term (weight
    reads + dispatch);
  * the node is **memory-bound** when the KVCache byte traffic dominates,
    **compute-bound** when the per-token FLOPs dominate — both regimes
    emerge from the same max(compute, memory) formulation below;
  * KVCache capacity caps the admissible batch (Fig. 2(b)/5(a)).

Default constants model the paper's larger testbed (Qwen3-32B on one
H800-96GB); ``a40_llama8b()`` models the smaller one and
``tpu_v5e_pod8_32b()`` the TPU adaptation from DESIGN.md.
The constants only set the scale; the scheduler comparisons depend on the
*structure* (linearity in KV tokens + capacity bound), which follows the
paper's measurements.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["NodeSpec", "ServiceModel", "ScaledServiceModel"]


@dataclass(frozen=True)
class NodeSpec:
    """Hardware + model constants for one serving node."""

    name: str = "h800-qwen3-32b"       # the paper's Sec. 4.1 testbed node
    peak_flops: float = 990e12          # dense bf16 FLOP/s (H100-class)
    hbm_bandwidth: float = 3.35e12      # bytes/s (H800 HBM3)
    hbm_bytes: float = 96 * 2**30       # total HBM
    weight_bytes: float = 64e9          # ~32B params bf16
    flops_per_token: float = 64e9       # ~2 * params per generated token
    kv_bytes_per_token: float = 262144  # 64L * 8kvh * 128d * 2(KV) * 2B
    mfu: float = 0.55                   # achievable fraction of peak
    mbu: float = 0.8                    # achievable fraction of HBM bw
    swap_bandwidth: float = 64e9        # host link (swap in/out)
    swap_overlap: float = 0.8           # fraction hidden by overlapping
    fixed_overhead_s: float = 2e-4      # dispatch / collective latency
    max_batch: int = 256
    kv_reserve_fraction: float = 0.1    # activations + fragmentation slack

    @property
    def kv_capacity_tokens(self) -> int:
        free = (self.hbm_bytes - self.weight_bytes) * (1 - self.kv_reserve_fraction)
        return max(1, int(free / self.kv_bytes_per_token))


def h800_qwen32b() -> NodeSpec:
    """The paper's larger testbed: Qwen3-32B on one H800-PCIe-96GB."""
    return NodeSpec()


def a40_llama8b() -> NodeSpec:
    """The paper's smaller testbed: Llama3.1-8B on one A40-PCIe-48GB."""
    return NodeSpec(
        name="a40-llama3.1-8b",
        peak_flops=150e12, hbm_bandwidth=696e9, hbm_bytes=48 * 2**30,
        weight_bytes=16e9, flops_per_token=16e9,
        kv_bytes_per_token=131072)  # 32L * 8kvh * 128d * 2 * 2B


def tpu_v5e_pod8_32b() -> NodeSpec:
    """TPU adaptation (DESIGN.md): 8-chip v5e slice serving a 32B model."""
    return NodeSpec(
        name="tpu-v5e-x8-32b",
        peak_flops=8 * 197e12, hbm_bandwidth=8 * 819e9,
        hbm_bytes=8 * 16 * 2**30, weight_bytes=64e9,
        flops_per_token=64e9, kv_bytes_per_token=262144)


@dataclass
class ServiceModel:
    spec: NodeSpec = field(default_factory=NodeSpec)

    # ------------------------------------------------------------- decode

    def decode_iteration_time(self, batch_size: int, total_kv_tokens: int
                              ) -> float:
        """One decode step for a batch holding ``total_kv_tokens`` context.

        compute:  B tokens * flops_per_token / (mfu * peak)
        memory:   weight reads + KV reads, at mbu * bandwidth
        The node is compute- or memory-bound depending on which dominates —
        the paper's Fig. 5(a) regimes.
        """
        s = self.spec
        compute = batch_size * s.flops_per_token / (s.mfu * s.peak_flops)
        mem_bytes = s.weight_bytes + total_kv_tokens * s.kv_bytes_per_token
        memory = mem_bytes / (s.mbu * s.hbm_bandwidth)
        return s.fixed_overhead_s + max(compute, memory)

    def decode_run_time(self, batch_size: int, start_kv_tokens: int,
                        n_steps: int) -> float:
        """Closed-form time for ``n_steps`` consecutive decode steps with a
        fixed active set (each step adds ``batch_size`` KV tokens).

        Exact when the binding regime does not flip mid-run; the simulator
        only uses runs short enough (<= one bucket) for this to hold to
        first order, and regime flips within a run only smooth the max().
        """
        s = self.spec
        if n_steps <= 0:
            return 0.0
        compute = batch_size * s.flops_per_token / (s.mfu * s.peak_flops)
        bw = s.mbu * s.hbm_bandwidth
        # memory term summed over steps: n*W + kv_bpt*(n*T0 + B*n(n-1)/2)
        kv_tokens_sum = (n_steps * start_kv_tokens
                         + batch_size * n_steps * (n_steps - 1) // 2)
        mem_time = (n_steps * s.weight_bytes
                    + kv_tokens_sum * s.kv_bytes_per_token) / bw
        comp_time = n_steps * compute
        return n_steps * s.fixed_overhead_s + max(comp_time, mem_time)

    # ------------------------------------------------------------ prefill

    def prefill_time(self, input_tokens: int) -> float:
        """Prefill is compute-bound (Sarathi/DistServe observation):
        quadratic attention + linear FFN over the prompt."""
        s = self.spec
        ffn = input_tokens * s.flops_per_token
        # attention ~ flops_per_token is dominated by FFN until long ctx;
        # approximate the quadratic part against a 4k knee
        attn = input_tokens * max(0, input_tokens - 512) * (s.flops_per_token / 8192)
        return s.fixed_overhead_s + (ffn + attn) / (s.mfu * s.peak_flops)

    def prefill_chunk_time(self, chunk_tokens: int, past_tokens: int
                           ) -> float:
        """One Sarathi-style prefill chunk of ``chunk_tokens`` against an
        already-cached prefix of ``past_tokens``: linear FFN over the
        chunk + attention of the chunk's queries against the full prefix
        (same 512-token knee as ``prefill_time``), plus one iteration's
        fixed overhead — the per-chunk dispatch cost that makes chunking
        a throughput/TTFT trade, not a free lunch."""
        s = self.spec
        ffn = chunk_tokens * s.flops_per_token
        ctx = past_tokens + chunk_tokens
        attn = chunk_tokens * max(0, ctx - 512) * (s.flops_per_token / 8192)
        return s.fixed_overhead_s + (ffn + attn) / (s.mfu * s.peak_flops)

    def prefill_time_shared(self, input_tokens: int,
                            cached_prefix: int) -> float:
        """Prefill cost when the leading ``cached_prefix`` tokens' KV is
        already resident (adopted from the prefix index — the engine's
        copy-on-write sharing): only the remainder is computed, as one
        chunk attending to the cached prefix.  ``cached_prefix <= 0``
        degrades to the atomic ``prefill_time``; a fully-cached prompt
        still pays one dispatch (the engine always recomputes at least
        the final position).  Composed from the primitives, so
        ``ScaledServiceModel`` inherits the scaling."""
        cached = max(0, min(int(cached_prefix), int(input_tokens)))
        if cached == 0:
            return self.prefill_time(input_tokens)
        return self.prefill_chunk_time(max(1, input_tokens - cached),
                                       cached)

    def prefill_time_chunked(self, input_tokens: int,
                             chunk: int | None) -> float:
        """Total prefill time when split into ``chunk``-token pieces
        (``None`` or >= input_tokens: the atomic ``prefill_time``)."""
        if not chunk or chunk >= input_tokens:
            return self.prefill_time(input_tokens)
        total, done = 0.0, 0
        while done < input_tokens:
            take = min(chunk, input_tokens - done)
            total += self.prefill_chunk_time(take, done)
            done += take
        return total

    # --------------------------------------------------------------- swap

    def swap_time(self, kv_tokens: int, block_size: int = 1) -> float:
        """Un-overlapped cost of swapping a request's KV in or out.

        ``block_size > 1`` rounds the transfer up to whole KV blocks —
        the block-table accounting of ``serving.kv_cache.KVCacheManager``.
        Both the real engine and the simulator charge preemptions through
        THIS function, so the two layers share one preemption cost model.
        """
        s = self.spec
        if block_size > 1:
            kv_tokens = -(-int(kv_tokens) // block_size) * block_size
        raw = kv_tokens * s.kv_bytes_per_token / s.swap_bandwidth
        return raw * (1.0 - s.swap_overlap)


@dataclass
class ScaledServiceModel(ServiceModel):
    """A node running uniformly slower (or faster) by a constant factor —
    thermal throttling, a degraded interconnect, or an injected
    slow-node fault (``NodeSimulator.slow_down``).  Every primitive time
    is scaled, so the simulator's closed-form fast-forward math stays
    internally consistent; composite helpers (``prefill_time_chunked``)
    inherit the scaling through the primitives they call."""

    factor: float = 1.0

    def decode_iteration_time(self, batch_size, total_kv_tokens):
        return self.factor * super().decode_iteration_time(
            batch_size, total_kv_tokens)

    def decode_run_time(self, batch_size, start_kv_tokens, n_steps):
        return self.factor * super().decode_run_time(
            batch_size, start_kv_tokens, n_steps)

    def prefill_time(self, input_tokens):
        return self.factor * super().prefill_time(input_tokens)

    def prefill_chunk_time(self, chunk_tokens, past_tokens):
        return self.factor * super().prefill_chunk_time(
            chunk_tokens, past_tokens)

    def swap_time(self, kv_tokens, block_size=1):
        return self.factor * super().swap_time(kv_tokens, block_size)
