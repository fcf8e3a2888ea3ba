"""Tolerance contract for parallel="efficient" serving parity.

Exact mode's contract is trivial: token streams are bit-identical to
the single-device engine.  Efficient mode reorders float contractions
(row-parallel psums, vocab-sharded reductions, LSE-combined attention
stripes), so its contract is statistical: last-ulp logit drift may flip
a token exactly where the sampling decision was already a coin toss —
two logits within one ulp of each other, or a categorical draw landing
within one ulp of a CDF boundary.  MoE amplifies this (a flipped
routing pick swaps whole expert FFNs), which is why the bar is a match
*rate* over long decodes, not a per-token guarantee.

``assert_tokens_close`` is that contract, shared by the parity tests,
the benchmark harness, and anyone wiring a new mesh layout: streams
must agree position-by-position at >= ``min_match_rate`` (0.999), and
any divergence must be *suffix* drift — once one token flips, the
autoregressive state differs and all later mismatches are expected, so
only the first divergence point per stream is charged against the
rate.  ``bit_identical=True`` restores the exact-mode contract (used
at tp=1, where efficient mode degenerates to no resharding at all).
"""

from __future__ import annotations

import numpy as np

__all__ = ["assert_tokens_close", "TokenMismatch"]


class TokenMismatch(AssertionError):
    """Raised with the per-stream divergence diagnostics attached."""

    def __init__(self, msg, mismatches):
        super().__init__(msg)
        self.mismatches = mismatches


def _first_divergence(got, want):
    """Index of the first differing position, or None if equal (the
    shorter stream's early stop counts as a divergence at its end)."""
    n = min(len(got), len(want))
    for i in range(n):
        if got[i] != want[i]:
            return i
    if len(got) != len(want):
        return n
    return None


def assert_tokens_close(got, want, *, min_match_rate: float = 0.999,
                        bit_identical: bool = False,
                        logits=None, ref_logits=None,
                        max_logit_diff: float = 5e-2,
                        label: str = "") -> dict:
    """Check generated token streams against a reference.

    got/want: sequence of streams (each a sequence of token ids), or a
    single stream of ints.  Returns a stats dict (matched, compared,
    rate, divergences) on success so callers can log the margin.

    The rate counts positions up to each stream's first divergence:
    autoregressive drift past a flip is not independent evidence.  With
    ``bit_identical=True`` any divergence fails.  When ``logits`` /
    ``ref_logits`` are given (arrays of matching shape), their max
    abs diff must stay under ``max_logit_diff`` — catching layouts that
    are only agreeing by sampling luck.
    """
    if got and isinstance(got[0], (int, np.integer)):
        got, want = [got], [want]
    if len(got) != len(want):
        raise TokenMismatch(
            f"{label}: {len(got)} streams vs {len(want)} reference "
            "streams", [])

    matched = compared = 0
    mismatches = []
    for si, (g, w) in enumerate(zip(got, want)):
        g, w = list(g), list(w)
        d = _first_divergence(g, w)
        if d is None:
            matched += len(w)
            compared += len(w)
        else:
            matched += d
            compared += d + 1   # charge exactly the flip position
            mismatches.append(
                {"stream": si, "pos": d,
                 "got": g[d] if d < len(g) else None,
                 "want": w[d] if d < len(w) else None})
    if bit_identical and mismatches:
        raise TokenMismatch(
            f"{label}: expected bit-identical streams, "
            f"{len(mismatches)} diverged (first: {mismatches[0]})",
            mismatches)
    rate = matched / compared if compared else 1.0
    if rate < min_match_rate:
        raise TokenMismatch(
            f"{label}: greedy/sampled match rate {rate:.4f} < "
            f"{min_match_rate} ({matched}/{compared} positions; "
            f"first divergences: {mismatches[:4]})", mismatches)

    stats = {"matched": matched, "compared": compared, "rate": rate,
             "divergences": len(mismatches)}
    if logits is not None and ref_logits is not None:
        diff = float(np.max(np.abs(
            np.asarray(logits, np.float32)
            - np.asarray(ref_logits, np.float32))))
        stats["max_logit_diff"] = diff
        if diff > max_logit_diff:
            raise TokenMismatch(
                f"{label}: max logit drift {diff:.3e} > "
                f"{max_logit_diff:.3e} — the layout is numerically "
                "wrong, not just reordered", mismatches)
    return stats
