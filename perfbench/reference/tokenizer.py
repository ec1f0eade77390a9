"""The reference's own tokenizer: BERT-uncased basic splitting, then greedy
longest-match-first WordPiece, over the vocabulary the benchmark hands the
program (``make_test_vocab`` with the benchmark's words added), rebuilt
here from the same lists. Plain Python; imports nothing of the program."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
_LETTERS = [chr(c) for c in range(ord("a"), ord("z") + 1)]
_BASE_WORDS = ["a", "the", "person", "dog", "cat", "runs", "jumps", "video", "man", "woman",
               "is", "playing", "ball", "red", "blue", "green", "what", "who", "how",
               "where", "when"]


def vocab(extra_words: Sequence[str]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for tok in _SPECIALS + _LETTERS + ["##" + c for c in _LETTERS] + _BASE_WORDS + list(
            extra_words):
        out.setdefault(tok, len(out))
    return out


def _words(text: str) -> List[str]:
    out, word = [], []
    for ch in text.lower():
        if ch.isalnum() or ch == "'":
            word.append(ch)
            continue
        if word:
            out.append("".join(word))
            word = []
        if not ch.isspace():
            out.append(ch)
    if word:
        out.append("".join(word))
    return out


def _pieces(word: str, voc: Dict[str, int]) -> List[str]:
    if len(word) > 100:
        return ["[UNK]"]
    pieces, start = [], 0
    while start < len(word):
        for end in range(len(word), start, -1):
            sub = word[start:end] if start == 0 else "##" + word[start:end]
            if sub in voc:
                pieces.append(sub)
                start = end
                break
        else:
            return ["[UNK]"]
    return pieces


def encode(texts: Sequence[str], voc: Dict[str, int],
           max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(ids, mask), each (len(texts), max_length) int64: [CLS] pieces [SEP],
    cut to ``max_length``, padded with [PAD]."""
    ids = np.full((len(texts), max_length), voc["[PAD]"], np.int64)
    mask = np.zeros((len(texts), max_length), np.int64)
    for i, text in enumerate(texts):
        row = [voc.get(p, voc["[UNK]"]) for w in _words(text) for p in _pieces(w, voc)]
        row = [voc["[CLS]"]] + row[:max_length - 2] + [voc["[SEP]"]]
        ids[i, :len(row)] = row
        mask[i, :len(row)] = 1
    return ids, mask
