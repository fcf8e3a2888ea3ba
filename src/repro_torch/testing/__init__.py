"""Invariant-checking helpers of the port (the fault toolkit is ROADMAP
Queue A 8)."""

from .tolerance import TokenMismatch, assert_tokens_close

__all__ = ["TokenMismatch", "assert_tokens_close"]
