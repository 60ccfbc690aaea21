"""Tokenizer and chat template (port of inferd_tpu/core/tokenizer.py).

The HF tokenizer when `transformers` imports and the tokenizer files are
already on this machine (`local_files_only=True`: nothing is downloaded);
otherwise a deterministic byte-level tokenizer (ids = bytes, specials
above 255), with a logged warning, so generation runs where no tokenizer
files exist. `transformers` is imported only when a model name is given.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence

log = logging.getLogger(__name__)


class ByteTokenizer:
    """Byte-level fallback: token id = byte value; specials above 255. The
    surface the generation loop needs: encode, decode, a chat template and
    an EOS id."""

    vocab_size = 259
    bos_token_id = 256
    eos_token_id = 257
    pad_token_id = 258

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages, add_generation_prompt: bool = True) -> List[int]:
        parts = [f"<|{m['role']}|>\n{m['content']}\n" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return [self.bos_token_id] + self.encode("".join(parts))


class Tokenizer:
    """Facade: the HF tokenizer when available locally, ByteTokenizer otherwise."""

    def __init__(self, model_name: Optional[str] = None):
        self.hf = None
        self.model_name = model_name
        if model_name:
            try:
                from transformers import AutoTokenizer

                self.hf = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
            except Exception as e:  # no package, no local files, or unreadable files
                # byte-level ids are meaningless against a real vocabulary:
                # never fall back silently
                log.warning(
                    "could not load HF tokenizer %r (%s: %s); falling back to "
                    "byte-level tokenizer — only sensible for toy/test models",
                    model_name, type(e).__name__, e,
                )
                self.hf = None
        self._fallback = ByteTokenizer()

    @property
    def eos_token_id(self) -> int:
        if self.hf is not None and self.hf.eos_token_id is not None:
            return self.hf.eos_token_id
        return self._fallback.eos_token_id

    def encode(self, text: str) -> List[int]:
        if self.hf is not None:
            return self.hf.encode(text)
        return self._fallback.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        if self.hf is not None:
            return self.hf.decode(ids, skip_special_tokens=True)
        return self._fallback.decode(ids)

    def apply_chat_template(self, messages, add_generation_prompt: bool = True) -> List[int]:
        if self.hf is not None:
            return self.hf.apply_chat_template(
                messages, add_generation_prompt=add_generation_prompt, tokenize=True)
        return self._fallback.apply_chat_template(messages, add_generation_prompt)
