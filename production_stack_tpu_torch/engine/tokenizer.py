"""Tokenizers: a byte-level tokenizer and local HF tokenizers.

A copy of the JAX package's ``engine/tokenizer.py`` without chat
templating (the chat route is not ported yet). Tokenizers load only from
local directories; ``transformers`` is imported only when an HF tokenizer
is asked for.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence, Tuple

from ..logging_utils import init_logger

logger = init_logger(__name__)


class Tokenizer(Protocol):
    vocab_size: int
    eos_token_ids: Tuple[int, ...]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...


class ByteTokenizer:
    """utf-8 bytes as token ids 1..256; id 0 is EOS/pad."""

    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size
        self.eos_token_ids: Tuple[int, ...] = (0,)

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return [b + 1 for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i - 1 for i in ids if 1 <= i <= 256).decode(
            "utf-8", errors="replace"
        )


class HFTokenizer:
    """transformers.AutoTokenizer over a local directory."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self._tok)
        eos = self._tok.eos_token_id
        self.eos_token_ids: Tuple[int, ...] = tuple(
            eos if isinstance(eos, (list, tuple)) else [eos] if eos is not None else []
        )

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_special_tokens)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)


def get_tokenizer(spec: Optional[str], vocab_size: int = 512) -> Tokenizer:
    """``spec``: local HF dir, or None/"byte" for the byte tokenizer."""
    if spec and spec != "byte":
        try:
            return HFTokenizer(spec)
        except Exception as e:
            logger.warning("HF tokenizer load failed (%s); using byte tokenizer", e)
    return ByteTokenizer(vocab_size)
