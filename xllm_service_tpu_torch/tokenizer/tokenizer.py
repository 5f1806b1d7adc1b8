"""Tokenization (copies of the file-free parts of
xllm_service_tpu/tokenizer/tokenizer.py): the deterministic byte-level
tokenizer that tests and benches use, and the streaming detokenizer.
Model tokenizers (native BPE / SentencePiece / tiktoken, HF) are not
ported yet."""

from __future__ import annotations

from typing import List, Optional, Sequence


class Tokenizer:
    """Interface."""

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        raise NotImplementedError

    @property
    def eos_token_id(self) -> Optional[int]:
        return None


class ByteTokenizer(Tokenizer):
    """UTF-8 byte-level tokenizer: id = byte + 3 (0=pad, 1=bos, 2=eos)."""

    PAD, BOS, EOS = 0, 1, 2
    _OFFSET = 3

    def encode(self, text: str) -> List[int]:
        return [b + self._OFFSET for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        # Total over arbitrary ids: a model whose vocab exceeds 259 may emit
        # any id, folded onto a byte.
        data = bytes((i - self._OFFSET) % 256 for i in ids if i >= self._OFFSET)
        return data.decode("utf-8", errors="replace")

    @property
    def eos_token_id(self) -> Optional[int]:
        return self.EOS


class IncrementalDetokenizer:
    """Streaming-safe detokenization for one sequence: keeps the id
    history, re-decodes, and emits only newly stable text (a trailing run
    of U+FFFD is held back until later tokens complete the character)."""

    def __init__(self, tokenizer: Tokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = 0

    def push(self, ids: Sequence[int]) -> str:
        self._ids.extend(int(i) for i in ids)
        text = self._tok.decode(self._ids)
        stable_end = len(text)
        while stable_end > self._emitted and text[stable_end - 1] == "�":
            stable_end -= 1
        delta = text[self._emitted:stable_end]
        self._emitted = stable_end
        return delta

    def flush(self) -> str:
        """Emit whatever is still held back (end of stream)."""
        text = self._tok.decode(self._ids)
        delta = text[self._emitted:]
        self._emitted = len(text)
        return delta


def create_tokenizer(path: str = "") -> Tokenizer:
    """Empty path (or "byte") selects the byte tokenizer."""
    if not path or path == "byte":
        return ByteTokenizer()
    raise NotImplementedError(f"tokenizer {path!r}: only the byte tokenizer is ported")
