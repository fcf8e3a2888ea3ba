"""Deterministic byte-level tokenizer (no external vocab files).

Tokens: 0 = <eos>, 1 = <pad>, 2 = <bos>, bytes map to 3..258.  For models
with larger vocabularies the byte ids simply occupy the low end; synthetic
training data samples the full range.
"""

from __future__ import annotations

__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    eos_id = 0
    pad_id = 1
    bos_id = 2
    offset = 3

    @property
    def vocab_size(self) -> int:
        return 256 + self.offset

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> list[int]:
        ids = [b + self.offset for b in text.encode("utf-8")]
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        bs = bytes(i - self.offset for i in ids
                   if i >= self.offset and i - self.offset < 256)
        return bs.decode("utf-8", errors="replace")
