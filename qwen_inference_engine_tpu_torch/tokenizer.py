"""Byte-level tokenizer: the fallback the preset path of the CLI uses.

One token per UTF-8 byte, offset by the number of special tokens, so any
text round-trips without tokenizer files.  Checkpoint tokenizers arrive
with the checkpoint loaders, in a later slice.
"""

from __future__ import annotations

from typing import List, Sequence


class ByteTokenizer:
    """Deterministic byte-level tokenizer; ids ``4..259`` are the bytes."""

    SPECIALS = {"<pad>": 0, "<eos>": 1, "<im_start>": 2, "<im_end>": 3}

    def __init__(self):
        self.vocab_size = 256 + len(self.SPECIALS)
        self.eos_token_id = self.SPECIALS["<eos>"]
        self.pad_token_id = self.SPECIALS["<pad>"]

    def encode(self, text: str) -> List[int]:
        off = len(self.SPECIALS)
        return [b + off for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        off = len(self.SPECIALS)
        data = bytes(i - off for i in ids if off <= i < off + 256)
        return data.decode("utf-8", errors="replace")
