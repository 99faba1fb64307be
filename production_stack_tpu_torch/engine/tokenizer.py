"""Tokenizers: a byte-level tokenizer and local HF tokenizers.

A copy of the JAX package's ``engine/tokenizer.py``, with its chat
templating, the cross-encoder's sentence pairs (``encode_pair``) and a
``ChatMessage`` of its own. Tokenizers load only from local
directories; ``transformers`` is imported only when an HF tokenizer is
asked for.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple, Union

from ..logging_utils import init_logger

logger = init_logger(__name__)

_ROLES = ("system", "user", "assistant", "tool")


@dataclasses.dataclass
class ChatMessage:
    """One message of a chat request, as the JAX package's protocol
    model reads it: string content, or a list of parts whose ``text``
    parts are joined."""

    role: str = "user"
    content: Union[str, List[Dict[str, Any]], None] = None
    name: Optional[str] = None

    @classmethod
    def from_dict(cls, raw) -> "ChatMessage":
        """A message from a request body's dict (other keys ignored);
        raises ValueError on what the JAX protocol model refuses."""
        if not isinstance(raw, dict):
            raise ValueError("each message must be a JSON object")
        role = raw.get("role", "user")
        if role not in _ROLES:
            raise ValueError(f"message role must be one of {_ROLES}")
        content = raw.get("content")
        if content is not None and not isinstance(content, (str, list)):
            raise ValueError("message content must be a string or a list")
        name = raw.get("name")
        return cls(role, content, None if name is None else str(name))

    def text(self) -> str:
        if isinstance(self.content, str):
            return self.content
        if isinstance(self.content, list):
            return "".join(
                part.get("text", "")
                for part in self.content
                if isinstance(part, dict) and part.get("type", "text") == "text"
            )
        return ""


class Tokenizer(Protocol):
    vocab_size: int
    eos_token_ids: Tuple[int, ...]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]: ...

    def decode(self, ids: Sequence[int]) -> str: ...

    def apply_chat_template(
        self,
        messages: List[ChatMessage],
        add_generation_prompt: bool = True,
        continue_final_message: bool = False,
    ) -> str: ...


def _fallback_chat_template(
    messages: List[ChatMessage],
    add_generation_prompt: bool,
    continue_final_message: bool = False,
) -> str:
    parts = [f"<|{m.role}|>\n{m.text()}\n" for m in messages]
    if continue_final_message:
        # Leave the final message's turn open (no terminator, no new
        # generation prompt): the model continues it mid-sentence, which
        # is what a resumed stream's continuation relies on.
        if parts:
            parts[-1] = parts[-1][:-1]
        return "".join(parts)
    if add_generation_prompt:
        parts.append("<|assistant|>\n")
    return "".join(parts)


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

    def encode_pair(
        self, a: str, b: str, max_len: Optional[int] = None
    ) -> Tuple[List[int], List[int]]:
        """(ids, segment ids) of a pair: ``a``, the separator 258 (outside
        the byte ids 1..256), ``b``; segment 0 for ``a`` and the
        separator, 1 for ``b``. Longest-first truncation to ``max_len``
        keeps the template whole."""
        ia, ib = self.encode(a), self.encode(b)
        if max_len is not None:
            budget = max_len - 1  # the separator
            while len(ia) + len(ib) > budget:
                if len(ia) >= len(ib):
                    ia.pop()
                else:
                    ib.pop()
        return ia + [258] + ib, [0] * (len(ia) + 1) + [1] * len(ib)

    def apply_chat_template(
        self,
        messages: List[ChatMessage],
        add_generation_prompt: bool = True,
        continue_final_message: bool = False,
    ) -> str:
        return _fallback_chat_template(
            messages, add_generation_prompt, continue_final_message
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

    def encode_pair(
        self, a: str, b: str, max_len: Optional[int] = None
    ) -> Tuple[List[int], List[int]]:
        """The model's own pair template (RoBERTa: <s> a </s></s> b </s>;
        BERT: [CLS] a [SEP] b [SEP] with segment ids), truncated
        ``longest_first`` by the tokenizer, which keeps the final special
        tokens."""
        kwargs = {}
        if max_len is not None:
            kwargs = {"truncation": "longest_first", "max_length": max_len}
        enc = self._tok(a, b, **kwargs)
        ids = enc["input_ids"]
        types = enc.get("token_type_ids") or [0] * len(ids)
        return ids, types

    def apply_chat_template(
        self,
        messages: List[ChatMessage],
        add_generation_prompt: bool = True,
        continue_final_message: bool = False,
    ) -> str:
        dicts = [{"role": m.role, "content": m.text()} for m in messages]
        kwargs = {"tokenize": False,
                  "add_generation_prompt": add_generation_prompt}
        if continue_final_message:
            # An older transformers takes an unknown keyword into its
            # **kwargs and renders the final turn closed, without an
            # error: check for real support, or render with the fallback
            # template (whose final turn stays open).
            params = inspect.signature(self._tok.apply_chat_template).parameters
            if "continue_final_message" not in params:
                logger.warning(
                    "tokenizer lacks continue_final_message; rendering "
                    "the continuation with the fallback chat template"
                )
                return _fallback_chat_template(
                    messages, add_generation_prompt, continue_final_message
                )
            kwargs["continue_final_message"] = True
        try:
            return self._tok.apply_chat_template(dicts, **kwargs)
        except Exception:  # noqa: BLE001 — no template: the fallback
            return _fallback_chat_template(
                messages, add_generation_prompt, continue_final_message
            )


def get_tokenizer(spec: Optional[str], vocab_size: int = 512) -> Tokenizer:
    """``spec``: local HF dir, or None/"byte" for the byte tokenizer."""
    if spec and spec != "byte":
        try:
            return HFTokenizer(spec)
        except Exception as e:
            logger.warning("HF tokenizer load failed (%s); using byte tokenizer", e)
    return ByteTokenizer(vocab_size)
