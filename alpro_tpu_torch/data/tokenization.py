"""Tokenization: BERT WordPiece.

The port's own copy of ``alpro_tpu/data/tokenization.py``. ALPRO tokenizes
with HF ``BertTokenizerFast.from_pretrained(cfg.tokenizer_dir)`` over a local
``ext/bert-base-uncased/`` vocab; the same here when a vocab directory is
given and ``transformers`` is installed (imported only then).
``WordPieceTokenizer`` is a self-contained greedy-longest-match
implementation used when HF assets are unavailable and in tests.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece with BERT-uncased conventions."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_input_chars_per_word: int = 100):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.lowercase = lowercase
        self.max_input_chars_per_word = max_input_chars_per_word
        self.pad_token, self.unk_token = "[PAD]", "[UNK]"
        self.cls_token, self.sep_token, self.mask_token = "[CLS]", "[SEP]", "[MASK]"
        for tok in (self.pad_token, self.unk_token, self.cls_token,
                    self.sep_token, self.mask_token):
            assert tok in vocab, f"vocab missing {tok}"
        self.pad_token_id = vocab[self.pad_token]
        self.unk_token_id = vocab[self.unk_token]
        self.cls_token_id = vocab[self.cls_token]
        self.sep_token_id = vocab[self.sep_token]
        self.mask_token_id = vocab[self.mask_token]
        self._special_ids = {
            self.pad_token_id, self.cls_token_id, self.sep_token_id,
            self.mask_token_id, self.unk_token_id,
        }

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    # -- text → pieces -----------------------------------------------------
    def _basic_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        out: List[str] = []
        word = []
        for ch in text:
            if ch.isalnum() or ch == "'":
                word.append(ch)
            else:
                if word:
                    out.append("".join(word))
                    word = []
                if not ch.isspace():
                    out.append(ch)
        if word:
            out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_input_chars_per_word:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [
            p for w in self._basic_tokenize(text) for p in self._wordpiece(w)
        ]

    def encode(self, text: str, max_length: int = 40) -> List[int]:
        ids = [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]
        ids = ids[: max_length - 2]
        return [self.cls_token_id] + ids + [self.sep_token_id]

    def __call__(
        self,
        texts: Sequence[str],
        max_length: int = 40,
        padding: str = "max_length",
    ) -> Dict[str, np.ndarray]:
        encoded = [self.encode(t, max_length) for t in texts]
        L = max_length if padding == "max_length" else max(len(e) for e in encoded)
        ids = np.full((len(texts), L), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(texts), L), dtype=np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return {"input_ids": ids, "attention_mask": mask}

    # -- HF-compatible surfaces used by the MLM masker ---------------------
    def get_special_tokens_mask(
        self, ids: Sequence[int], already_has_special_tokens: bool = True
    ) -> List[int]:
        return [1 if i in self._special_ids else 0 for i in ids]

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self.vocab.get(tokens, self.unk_token_id)
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids):
        if isinstance(ids, int):
            return self.inv_vocab.get(ids, self.unk_token)
        return [self.inv_vocab.get(i, self.unk_token) for i in ids]

    def decode_pieces(self, ids: Sequence[int]) -> str:
        words: List[str] = []
        for i in ids:
            t = self.inv_vocab.get(int(i), self.unk_token)
            if t in (self.pad_token, self.cls_token, self.sep_token):
                continue
            if t.startswith("##") and words:
                words[-1] += t[2:]
            else:
                words.append(t)
        return " ".join(words)


class HFTokenizerAdapter:
    """Wraps an HF tokenizer to the collator contract: fixed-length numpy
    batches (HF defaults to no padding/truncation unless asked)."""

    def __init__(self, hf):
        self._hf = hf
        self.pad_token_id = hf.pad_token_id
        self.mask_token_id = hf.mask_token_id
        self.vocab_size = len(hf)

    def __call__(self, texts, max_length: int = 40, padding: str = "max_length"):
        enc = self._hf(
            list(texts), max_length=max_length, padding=padding,
            truncation=True, return_attention_mask=True,
        )
        return {
            "input_ids": np.asarray(enc["input_ids"], np.int32),
            "attention_mask": np.asarray(enc["attention_mask"], np.int32),
        }

    def get_special_tokens_mask(self, ids, already_has_special_tokens=True):
        return self._hf.get_special_tokens_mask(
            ids, already_has_special_tokens=already_has_special_tokens
        )

    def convert_tokens_to_ids(self, tokens):
        return self._hf.convert_tokens_to_ids(tokens)

    def convert_ids_to_tokens(self, ids):
        return self._hf.convert_ids_to_tokens(ids)


def build_tokenizer(tokenizer_dir: Optional[str] = None):
    """HF fast tokenizer when assets exist, WordPieceTokenizer otherwise."""
    if tokenizer_dir and os.path.isdir(tokenizer_dir):
        vocab_file = os.path.join(tokenizer_dir, "vocab.txt")
        try:
            from transformers import BertTokenizerFast

            return HFTokenizerAdapter(
                BertTokenizerFast.from_pretrained(tokenizer_dir)
            )
        except Exception as e:
            if os.path.exists(vocab_file):
                # loud: the fallback's BasicTokenizer is simplified (no
                # accent stripping / CJK / full punctuation classes) — fine
                # for fixtures, a silent parity trap on real captions
                import logging

                logging.getLogger("alpro_tpu_torch").warning(
                    "HF tokenizer unavailable (%r); falling back to the "
                    "built-in WordPieceTokenizer, whose pre-tokenization is "
                    "simplified vs BERT BasicTokenizer — real-caption runs "
                    "should install/point at HF assets", e,
                )
                return WordPieceTokenizer.from_vocab_file(vocab_file)
            raise
    if tokenizer_dir and os.path.isfile(tokenizer_dir):
        return WordPieceTokenizer.from_vocab_file(tokenizer_dir)
    raise FileNotFoundError(
        f"tokenizer assets not found at {tokenizer_dir!r}; pass a directory "
        "with vocab.txt (reference: ext/bert-base-uncased/)"
    )


def make_test_vocab(extra_words: Sequence[str] = ()) -> Dict[str, int]:
    """Small deterministic vocab for fixtures/tests."""
    base = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    suffixes = ["##" + c for c in letters]
    words = [
        "a", "the", "person", "dog", "cat", "runs", "jumps", "video", "man",
        "woman", "is", "playing", "ball", "red", "blue", "green", "what",
        "who", "how", "where", "when",
    ]
    vocab_list = base + letters + suffixes + words + list(extra_words)
    seen, out = set(), {}
    for tok in vocab_list:
        if tok not in seen:
            out[tok] = len(out)
            seen.add(tok)
    return out
