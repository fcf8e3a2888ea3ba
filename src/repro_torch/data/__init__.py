"""Data helpers of the port: the byte tokenizer and the synthetic LM
dataset (numpy, as the reference's)."""

from .datasets import lm_batches, zipf_tokens
from .tokenizer import ByteTokenizer

__all__ = ["lm_batches", "zipf_tokens", "ByteTokenizer"]
