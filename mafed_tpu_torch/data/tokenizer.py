"""Tokenizer construction (counterpart of mafed_tpu/data/tokenizer.py).

The reference tokenizes with the Pythia (GPT-NeoX BPE) tokenizer, pad = eos =
<|endoftext|>, left padding. The port loads it only from a local directory
and only where `transformers` imports; it never reaches for a network. The
byte-level `ByteTokenizer` (ids in [0, 257) of the same 50304 vocabulary, id 0
= eos) is the fallback that tests and synthetic runs opt into: it changes
the vocabulary and every accuracy number, so a real run must not use it.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

LOGGER = logging.getLogger(__name__)


@dataclass
class Encoding:
    input_ids: List[int]


class ByteTokenizer:
    """Offline byte-level tokenizer with the HF surface this codebase uses.

    id 0 = eos (<|endoftext|> in Pythia), bytes map to 1..256.
    """

    eos_token = "<|endoftext|>"
    eos_token_id = 0
    pad_token_id = 0
    is_byte_fallback = True

    def __init__(self, model_max_length: int = 100, padding_side: str = "left") -> None:
        self.model_max_length = model_max_length
        self.padding_side = padding_side
        self.vocab_size = 50304

    def __call__(self, text: str, truncation: bool = False, max_length: Optional[int] = None) -> Encoding:
        ids = [b + 1 for b in text.encode("utf-8")]
        limit = max_length or (self.model_max_length if truncation else None)
        if truncation and limit:
            ids = ids[:limit]
        return Encoding(input_ids=ids)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        data = bytes(i - 1 for i in ids if 0 < int(i) <= 256)
        return data.decode("utf-8", errors="ignore")

    def batch_decode(self, batch, skip_special_tokens: bool = True) -> List[str]:
        return [self.decode(ids, skip_special_tokens) for ids in batch]


def build_tokenizer(
    tokenizer_name: str = "EleutherAI/pythia-410m",
    model_max_length: int = 100,
    padding_side: str = "left",
    truncation_side: str = "right",
    allow_fallback: bool = False,
):
    """The Pythia tokenizer from a local directory (`tokenizer_name`), with
    pad = eos and left padding; else, with `allow_fallback`, the byte-level
    tokenizer; else raise."""
    last_exc: Optional[Exception] = None
    if os.path.isdir(tokenizer_name):
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(
                tokenizer_name, local_files_only=True, model_max_length=model_max_length,
                padding_side=padding_side, truncation_side=truncation_side,
            )
            if tok.pad_token is None:
                tok.pad_token = tok.eos_token
            return tok
        except Exception as exc:  # transformers missing, or the directory holds no tokenizer
            last_exc = exc
    if not allow_fallback:
        reason = repr(last_exc) if last_exc is not None else "not a local directory"
        raise RuntimeError(
            f"tokenizer '{tokenizer_name}' is unavailable ({reason}). Point tokenizer_name at a local "
            "directory with the Pythia tokenizer files (transformers must be installed), or pass "
            "allow_fallback=True for the byte-level tokenizer (synthetic and test runs only: it changes "
            "the vocabulary and every accuracy number)."
        ) from last_exc
    LOGGER.warning("tokenizer '%s' unavailable; using the byte-level fallback", tokenizer_name)
    return ByteTokenizer(model_max_length=model_max_length, padding_side=padding_side)
