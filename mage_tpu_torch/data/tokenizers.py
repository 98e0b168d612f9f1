"""Caption tokenizers: the inline dataset vocabularies + a regex word
tokenizer.

Vocabularies match the reference exactly: Moving-MNIST 30 tokens
(dataload.py:199-203), CATER-GEN-v1 30 tokens (:300-303), CATER-GEN-v2 50
tokens (:305-312). The reference tokenizes CATER captions with
``nltk.word_tokenize`` (:326); captions in these datasets are templated,
so an equivalent regex (words / signed integers / punctuation) reproduces
it without nltk's downloadable models. An optional HuggingFace tokenizer
covers the reference's BertTokenizer path (dataload.py:15-73).
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

MNIST_VOCAB = {
    "[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "0": 3, "1": 4, "2": 5, "3": 6,
    "4": 7, "5": 8, "6": 9, "7": 10, "8": 11, "9": 12, "the": 13,
    "digit": 14, "and": 15, "is": 16, "are": 17, "bouncing": 18,
    "moving": 19, "here": 20, "there": 21, "around": 22, "jumping": 23,
    "up": 24, "down": 25, "left": 26, "right": 27, "then": 28, ".": 29,
}

CATERV1_VOCAB = {
    "[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "the": 3, "cone": 4, "snitch": 5,
    "is": 6, "sliding": 7, "picked": 8, "placed": 9, "containing": 10,
    "rotating": 11, "and": 12, "to": 13, "up": 14, "(": 15, ")": 16,
    "1": 17, "2": 18, "3": 19, "-1": 20, "-2": 21, "-3": 22, ",": 23,
    ".": 24, "first": 25, "second": 26, "third": 27, "fourth": 28,
    "quadrant": 29,
}

CATERV2_VOCAB = {
    "[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "the": 3, "cone": 4, "snitch": 5,
    "is": 6, "sliding": 7, "picked": 8, "placed": 9, "containing": 10,
    "and": 11, "to": 12, "up": 13, "sphere": 14, "cylinder": 15,
    "cube": 16, "small": 17, "medium": 18, "large": 19, "metal": 20,
    "rubber": 21, "gold": 22, "gray": 23, "red": 24, "blue": 25,
    "green": 26, "brown": 27, "purple": 28, "cyan": 29, "yellow": 30,
    "(": 31, ")": 32, "1": 33, "2": 34, "3": 35, "-1": 36, "-2": 37,
    "-3": 38, ",": 39, ".": 40, "rotating": 41, "while": 42,
    "contained": 43, "still": 44, "first": 45, "second": 46, "third": 47,
    "fourth": 48, "quadrant": 49,
}

_WORD_RE = re.compile(r"-?\d+|[A-Za-z\[\]]+|[(),.]")


def word_tokenize(text: str) -> list[str]:
    """Templated-caption tokenizer: words, signed integers, punctuation.
    Matches nltk.word_tokenize on the CATER caption grammar."""
    return _WORD_RE.findall(text)


class VocabTokenizer:
    """Fixed-vocabulary tokenizer with [CLS]/[SEP] wrapping, matching the
    reference's Dataset.encode/decode (dataload.py:215-238, 324-347)."""

    def __init__(self, vocab: dict, split_mode: str = "whitespace"):
        self.vocab = dict(vocab)
        self.inverse = {v: k for k, v in self.vocab.items()}
        self.split_mode = split_mode
        self.padding_idx = self.vocab["[PAD]"]
        self.cls_idx = self.vocab["[CLS]"]
        self.sep_idx = self.vocab["[SEP]"]

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _split(self, text: str) -> list[str]:
        if self.split_mode == "whitespace":
            return text.split()
        return word_tokenize(text)

    def encode(self, text: str) -> np.ndarray:
        ids = [self.cls_idx] + [self.vocab[w] for w in self._split(text)] + [self.sep_idx]
        return np.asarray(ids, dtype=np.int32)

    def encode_padded(self, text: str, context_length: int) -> np.ndarray:
        ids = self.encode(text)
        if len(ids) > context_length:
            raise ValueError(
                f"caption ({len(ids)} tokens) exceeds context_length {context_length}"
            )
        out = np.full((context_length,), self.padding_idx, dtype=np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, tokens: Sequence[int]) -> str:
        return " ".join(self.inverse[int(t)] for t in tokens)


def pad_text_batch(
    seqs: Sequence[np.ndarray], padding_idx: int, length: Optional[int] = None
) -> np.ndarray:
    """Pad a list of 1-D id arrays to a common length (the reference's
    pad_sequence collate, dataload.py:262-271; fixed ``length`` keeps
    shapes static for jit)."""
    n = len(seqs)
    length = length or max(len(s) for s in seqs)
    out = np.full((n, length), padding_idx, dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s[:length]
    return out


class HFTokenizer:
    """Optional BERT tokenizer via HuggingFace ``transformers`` — the
    reference's BertTokenizer path (dataload.py:15-73). Requires local
    pretrained files (zero-egress environments can't download)."""

    def __init__(self, model_path: str):
        from transformers import AutoTokenizer

        self.model_path = model_path
        self._tok = AutoTokenizer.from_pretrained(model_path)
        self.padding_idx = self._tok.pad_token_id

    def __getstate__(self):
        return {"model_path": self.model_path, "padding_idx": self.padding_idx}

    def __setstate__(self, state):
        from transformers import AutoTokenizer

        self.__dict__ = state
        self._tok = AutoTokenizer.from_pretrained(state["model_path"])

    def encode(self, text: str) -> np.ndarray:
        return np.asarray(self._tok.encode(text, add_special_tokens=True), np.int32)

    def decode(self, tokens) -> str:
        return self._tok.decode(list(map(int, tokens)))
