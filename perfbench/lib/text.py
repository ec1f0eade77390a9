"""Seeded captions and questions over a synthetic vocabulary.

The words are those of short video captions; the vocabulary is
``make_test_vocab``'s (specials, letters, ``##`` letters, a few words) with
these words added, so most words are one piece and the rest split into
letters, as WordPiece splits rare words."""

from __future__ import annotations

from typing import List

import numpy as np

WORDS = (
    "a the man woman person people child boy girl dog cat horse car bike ball "
    "guitar piano song food kitchen table room street road field beach water "
    "river mountain city crowd team game stage camera screen video clip news "
    "show movie cartoon robot phone computer book paper box tree flower grass "
    "sky snow rain sun light fire smoke is are was playing singing dancing "
    "talking cooking eating running walking jumping riding driving swimming "
    "climbing drawing painting reading writing showing explaining holding "
    "throwing catching opening closing cutting mixing pouring laughing crying "
    "red blue green yellow black white small big young old fast slow happy "
    "loud quiet in on at with of to from into over under near behind and or "
    "while then after before what who how where when why which does do did "
    "his her their its some many two three several another other first last"
).split()


def captions(seed_seq: np.random.SeedSequence, n: int, lo: int, hi: int) -> List[str]:
    """``n`` texts of ``lo``..``hi`` words drawn from ``WORDS``."""
    rng = np.random.default_rng(seed_seq)
    lengths = rng.integers(lo, hi + 1, size=n)
    return [" ".join(rng.choice(WORDS, size=int(k))) for k in lengths]
