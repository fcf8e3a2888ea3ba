"""What the per-layer metric readers (``metrics/<name>.py``) share: each
returns a number, or None where its window has nothing to read (no trace,
no step, no kernel of that name), and the harness then leaves the metric
out of the result.  Host metrics read the window; device metrics read the
traced span that follows it (``harness.Run``)."""

from __future__ import annotations

import re

from . import counts

__all__ = ["sched_ms_per_step", "preempt_per_100req", "step_ms",
           "mfu_busy_pct", "mfu_pct", "decode_attn_roofline_pct",
           "flash_prefill_roofline_pct", "device_idle_pct"]

# the program's kernels (csrc/decode_attention.cu, csrc/flash_attention.cu)
DECODE_ATTN = re.compile(r"\b(split_decode_kernel|split_decode_mma_kernel|"
                         r"merge_kernel)\b")
FLASH_PREFILL = re.compile(r"\bflash_prefill_kernel\b")


def _kernel_s(w, pattern) -> float:
    return sum(s for name, s in w.trace.kernel_s.items()
               if pattern.search(name))


def _traced(w):
    """The traced span's steps, or None without a trace."""
    if w.trace is None or w.trace_log is None or w.trace.window_s <= 0:
        return None
    return w.trace_log


def sched_ms_per_step(w):
    """Host ms a step spends in the scheduler's admission and ordering."""
    if not w.n_steps:
        return None
    return sum(w.log.sched) / w.n_steps * 1e3


def preempt_per_100req(w):
    """Preemptions in the window per 100 requests attempted."""
    if not w.attempted:
        return None
    return w.counters["preemptions"] / w.attempted * 100.0


def step_ms(w):
    """Host ms inside ``ServingEngine.step`` per step of the window."""
    if not w.n_steps:
        return None
    return sum(w.log.dur) / w.n_steps * 1e3


def _flops(w, log) -> int:
    a = w.arch
    f = 0
    for keys, lanes, chunks in zip(log.keys, log.lanes, log.chunks):
        f += counts.decode_flops(a, keys, lanes)
        for start, n in chunks:
            f += counts.prefill_flops(a, start, n)
    return f


def mfu_busy_pct(w):
    """Useful model FLOPs of the traced steps over the device's busy
    seconds at the bf16 peak."""
    log = _traced(w)
    if log is None or w.trace.busy_s <= 0:
        return None
    return _flops(w, log) / (w.trace.busy_s * counts.PEAK_BF16_FLOPS) \
        * 100.0


def mfu_pct(w):
    """Useful model FLOPs of the window over its seconds at the bf16
    peak."""
    if not w.n_steps or w.seconds <= 0:
        return None
    return _flops(w, w.log) / (w.seconds * counts.PEAK_BF16_FLOPS) * 100.0


def decode_attn_roofline_pct(w):
    """Least time of the traced steps' decode attention (its bytes at HBM
    bandwidth) over the decode attention kernels' time."""
    log = _traced(w)
    if log is None:
        return None
    t = _kernel_s(w, DECODE_ATTN)
    if t <= 0:
        return None
    need = sum(counts.decode_attention_bytes(w.arch, k, n)
               for k, n in zip(log.keys, log.lanes))
    return need / counts.PEAK_HBM_BYTES_S / t * 100.0


def flash_prefill_roofline_pct(w):
    """Least time of the traced steps' prefill attention (the larger of
    its operations at the bf16 peak and its bytes at HBM bandwidth) over
    the flash kernel's time."""
    log = _traced(w)
    if log is None:
        return None
    t = _kernel_s(w, FLASH_PREFILL)
    if t <= 0:
        return None
    least = 0.0
    for chunks in log.chunks:
        for start, n in chunks:
            least += max(
                counts.causal_chunk_flops(w.arch, start, n)
                / counts.PEAK_BF16_FLOPS,
                counts.chunk_attention_bytes(w.arch, start, n)
                / counts.PEAK_HBM_BYTES_S)
    return least / t * 100.0


def device_idle_pct(w):
    """Share of the traced span with no device operation running."""
    if w.trace is None or w.trace.window_s <= 0 or w.trace.busy_s <= 0:
        return None
    return (1.0 - w.trace.busy_s / w.trace.window_s) * 100.0
