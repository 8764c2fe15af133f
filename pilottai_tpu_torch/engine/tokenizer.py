"""Byte tokenizer and streaming detokenizer (the port's copy of
``pilottai_tpu/engine/tokenizer.py``; Hugging Face tokenizers wait for a
later slice). Ids 0..255 are raw bytes; pad, bos and eos follow; the
vocab is padded to a multiple of 128 (384). The engine renders prompts
with the generic chat transcript (``engine/base.py``)."""

from __future__ import annotations

from typing import List, Sequence


class ByteTokenizer:
    BYTE_VOCAB = 256

    def __init__(self, n_extra_specials: int = 0) -> None:
        self.pad_id = self.BYTE_VOCAB + 0
        self.bos_id = self.BYTE_VOCAB + 1
        self.eos_id = self.BYTE_VOCAB + 2
        base = self.BYTE_VOCAB + 3 + n_extra_specials
        self.vocab_size = ((base + 127) // 128) * 128

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < self.BYTE_VOCAB)
        return data.decode("utf-8", errors="replace")


class IncrementalDecoder:
    """Streaming detokenizer: ``push`` ids as they arrive, get text deltas
    whose concatenation equals ``decode(all_ids)``. A trailing U+FFFD (a
    partial UTF-8 sequence) is held back until the next push completes
    it, and text a non-monotonic decode would rewrite waits for
    ``flush``."""

    def __init__(self, tokenizer: ByteTokenizer) -> None:
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = ""

    def push(self, ids: Sequence[int]) -> str:
        self._ids.extend(ids)
        text = self._tok.decode(self._ids)
        if not text.startswith(self._emitted):
            return ""
        safe = len(text)
        while safe > len(self._emitted) and text[safe - 1] == "�":
            safe -= 1
        delta = text[len(self._emitted):safe]
        self._emitted += delta
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids)
        p = 0
        limit = min(len(text), len(self._emitted))
        while p < limit and text[p] == self._emitted[p]:
            p += 1
        delta = text[p:] if p < len(self._emitted) else text[len(self._emitted):]
        self._emitted += delta
        return delta

    @property
    def text(self) -> str:
        return self._emitted
