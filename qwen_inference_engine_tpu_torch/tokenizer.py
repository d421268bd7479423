"""Tokenizers: a checkpoint's HF tokenizer, and the byte-level fallback.

``load_tokenizer(path)`` gives ``HFTokenizer`` when ``path`` is a
directory with tokenizer files that ``transformers`` can load (local files
only), else ``ByteTokenizer``: one token per UTF-8 byte, offset by the
number of special tokens, so any text round-trips without tokenizer files
(and on a machine without ``transformers``, which is imported only inside
``HFTokenizer``).  ``StreamDecoder`` turns a token stream into text deltas
for the HTTP server's streaming.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


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

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            **kw) -> str:
        out = [f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n"
               for m in messages]
        if add_generation_prompt:
            out.append("<|im_start|>assistant\n")
        return "".join(out)


class HFTokenizer:
    """Thin wrapper over a local HuggingFace tokenizer (no network)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        self.eos_token_id = self._tok.eos_token_id
        self.pad_token_id = self._tok.pad_token_id or self._tok.eos_token_id

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            **kw) -> str:
        return self._tok.apply_chat_template(
            messages, tokenize=False,
            add_generation_prompt=add_generation_prompt, **kw)


def load_tokenizer(path: Optional[str] = None):
    """The HF tokenizer of ``path`` if it has tokenizer files that load,
    else the byte fallback."""
    if path and os.path.isdir(path):
        for f in ("tokenizer.json", "tokenizer_config.json", "vocab.json"):
            if os.path.exists(os.path.join(path, f)):
                try:
                    return HFTokenizer(path)
                except (ImportError, OSError, ValueError):
                    # no transformers, or files it cannot load
                    break
    return ByteTokenizer()


class StreamDecoder:
    """Incremental detokenizer for streaming responses.

    ``decode([tok])`` per token is wrong for byte-level tokens: a multi-byte
    UTF-8 character spans tokens, so per-token decodes emit U+FFFD mid
    stream.  This decodes the id window each push and emits only the stable
    suffix delta, holding back text that still ends in a replacement
    character (a partial code point the next token may complete).
    """

    _WINDOW = 256  # ids re-decoded per push (bounds the cost of long streams)

    def __init__(self, tok):
        self._tok = tok
        self._ids: List[int] = []
        self._start = 0      # window start (advanced at clean boundaries)
        self._emitted = 0    # chars of decode(ids[start:]) already emitted

    def push(self, token_id: int) -> str:
        self._ids.append(token_id)
        text = self._tok.decode(self._ids[self._start:])
        end = len(text)
        while end > self._emitted and text[end - 1] == "\ufffd":
            end -= 1
        delta = text[self._emitted:end]
        self._emitted = end
        # once everything is emitted the boundary is clean and the window
        # restarts, keeping a few ids of overlap so the next token still
        # decodes with context
        if (len(self._ids) - self._start > self._WINDOW
                and self._emitted == len(text)):
            self._start = max(0, len(self._ids) - 8)
            self._emitted = len(self._tok.decode(self._ids[self._start:]))
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids[self._start:])
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta
