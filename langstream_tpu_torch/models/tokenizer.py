"""Tokenizers (port of ``langstream_tpu/models/tokenizer.py``).

The byte-level tokenizer is the default: ids 0..255 are raw bytes plus
BOS/EOS/PAD specials — always available and reversible. ``HFTokenizer``
imports ``transformers`` only when a local tokenizer directory is named.
"""

from __future__ import annotations

from typing import Protocol


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int
    pad_id: int
    vocab_size: int

    def encode(self, text: str) -> list[int]: ...

    def decode(self, ids: list[int]) -> str: ...


class ByteTokenizer:
    """Byte-level: token id = byte value; specials above 255."""

    def __init__(self) -> None:
        self.pad_id = 256
        self.bos_id = 257
        self.eos_id = 258
        self.vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids: list[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


class HFTokenizer:
    """Wrapper over a local HuggingFace tokenizer directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.bos_id = self._tok.bos_token_id or 0
        self.eos_id = self._tok.eos_token_id or 0
        self.pad_id = self._tok.pad_token_id or self.eos_id
        self.vocab_size = self._tok.vocab_size

    def encode(self, text: str) -> list[int]:
        return self._tok.encode(text)

    def decode(self, ids: list[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)


def load_tokenizer(spec: str | None) -> Tokenizer:
    """``None``/``"byte"`` → ByteTokenizer; otherwise a local HF path."""
    if spec in (None, "byte", "bytes"):
        return ByteTokenizer()
    return HFTokenizer(spec)
