"""Shared pow2 bucket ladder.

One definition used by BOTH the serving engine (fused-step batch/table
buckets, prefill padding, the ``max_fused_compiles`` ladder bound) and
the paged decode kernel op (index-map page padding) — the CI-asserted
compile bound silently assumes the two ladders agree, so they must come
from one function.
"""

from __future__ import annotations

__all__ = ["pow2_bucket", "ladder_size"]


def pow2_bucket(n: int, floor: int = 1, cap: int | None = None) -> int:
    """Smallest power-of-two >= n (at least ``floor``), clamped to
    ``cap``.  Bucketing every dynamic dimension onto this ladder bounds
    the jit compile set to O(log) entries instead of one per distinct
    size."""
    b = max(1, floor)
    while b < n:
        b <<= 1
    return b if cap is None else min(b, cap)


def ladder_size(cap: int, floor: int = 1) -> int:
    """Number of distinct buckets pow2_bucket can emit for n in [1, cap]."""
    return len({pow2_bucket(n, floor, cap) for n in range(1, cap + 1)})
