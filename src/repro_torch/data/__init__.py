"""Data helpers of the port."""

from .tokenizer import ByteTokenizer

__all__ = ["ByteTokenizer"]
