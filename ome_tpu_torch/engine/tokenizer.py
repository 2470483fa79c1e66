"""Tokenizers for the serving engine.

A dependency-free byte-level tokenizer is the default (works with any
vocab >= 259 and makes CI/zero-egress tests hermetic); when a model dir
carries a real HF tokenizer, `load_tokenizer` upgrades to it via
`transformers` (baked into the image).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
_BYTE_OFFSET = 3


class ByteTokenizer:
    """UTF-8 bytes + {pad, bos, eos}. Reversible for any text."""

    vocab_size = 256 + _BYTE_OFFSET
    pad_id, bos_id, eos_id = PAD_ID, BOS_ID, EOS_ID

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + _BYTE_OFFSET for b in text.encode("utf-8")]
        return ([BOS_ID] + ids) if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        # ids past the byte range (models with larger vocabs) are skipped
        data = bytes(i - _BYTE_OFFSET for i in ids
                     if _BYTE_OFFSET <= i < _BYTE_OFFSET + 256)
        return data.decode("utf-8", errors="replace")

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        """Raw byte view (no str decode): the streaming path feeds
        these through an incremental UTF-8 decoder so a chunk ending
        mid-codepoint holds its tail bytes instead of flushing
        U+FFFD (server._stream)."""
        return bytes(i - _BYTE_OFFSET for i in ids
                     if _BYTE_OFFSET <= i < _BYTE_OFFSET + 256)

    def apply_chat_template(self, messages: List[dict]) -> str:
        parts = [f"{m.get('role', 'user')}: {m.get('content', '')}"
                 for m in messages]
        return "\n".join(parts) + "\nassistant:"


class HFTokenizer:
    """Thin adapter over transformers' PreTrainedTokenizer."""

    def __init__(self, tok):
        self._tok = tok
        self.vocab_size = len(tok)
        self.bos_id = tok.bos_token_id
        self.eos_id = tok.eos_token_id
        self.pad_id = tok.pad_token_id or 0

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def apply_chat_template(self, messages: List[dict]) -> str:
        try:
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        except Exception:
            return ByteTokenizer.apply_chat_template(self, messages)


def load_tokenizer(model_dir: Optional[str] = None):
    """HF tokenizer if the model dir ships one, else byte-level."""
    if model_dir and os.path.exists(
            os.path.join(model_dir, "tokenizer.json")):
        try:
            from transformers import AutoTokenizer
            return HFTokenizer(AutoTokenizer.from_pretrained(model_dir))
        except Exception:
            pass
    return ByteTokenizer()
