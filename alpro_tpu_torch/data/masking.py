"""Text MLM masking, entity pivots and patch-aligned random erasing (host
side, numpy).

The port's own copy of ``alpro_tpu/data/masking.py``: the same functions
making the same numpy draws in the same order, so that a generator in the
same state gives the same masks bit for bit:

  * ``mask_batch_text_tokens`` — BERT 80/10/10 masking;
  * ``select_text_pivots`` — whole-word entity pivot labels;
  * ``random_erase`` — a rectangle snapped to the patch grid, giving the
    (crop, patch mask, context) views of MPM.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

IGNORE_INDEX = -100


def mask_batch_text_tokens(
    inputs: np.ndarray,
    tokenizer,
    mlm_probability: float = 0.15,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """inputs: (B, L) token ids (already padded). Returns (masked_ids, labels)
    with labels = -100 at unmasked positions.

    tokenizer must expose: get_special_tokens_mask(ids, already_has_special_tokens),
    pad_token_id, mask_token_id, vocab_size.
    """
    rng = rng or np.random.default_rng()
    inputs = np.array(inputs, copy=True)
    labels = np.array(inputs, copy=True)

    prob = np.full(labels.shape, mlm_probability)
    special = np.asarray(
        [
            tokenizer.get_special_tokens_mask(row, already_has_special_tokens=True)
            for row in labels.tolist()
        ],
        dtype=bool,
    )
    prob[special] = 0.0
    if tokenizer.pad_token_id is not None:
        prob[labels == tokenizer.pad_token_id] = 0.0
    masked = rng.random(labels.shape) < prob
    labels[~masked] = IGNORE_INDEX

    replaced = (rng.random(labels.shape) < 0.8) & masked
    inputs[replaced] = tokenizer.mask_token_id

    randomized = (rng.random(labels.shape) < 0.5) & masked & ~replaced
    random_words = rng.integers(0, tokenizer.vocab_size, labels.shape)
    inputs[randomized] = random_words[randomized]
    # remaining 10%: keep original token
    return inputs, labels


def select_text_pivots(
    inputs: np.ndarray,
    tokenizer,
    ent2id: dict,
    pivot_probability: float = 1.0,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Whole-word entity pivot labeling (text-pivot pretrain variant).

    Non-special positions are grouped into whole words (a piece and the
    ``##`` pieces after it); the first piece of each selected word gets its
    entity id from ``ent2id`` (-100 elsewhere, and for words not in the
    entity vocabulary).

    Returns (labels, word_start_mask)."""
    rng = rng or np.random.default_rng()
    B, L = inputs.shape
    labels = np.full((B, L), IGNORE_INDEX, dtype=np.int64)
    word_start = np.zeros((B, L), dtype=bool)
    for b in range(B):
        toks = tokenizer.convert_ids_to_tokens([int(t) for t in inputs[b]])
        special = tokenizer.get_special_tokens_mask(
            [int(t) for t in inputs[b]], already_has_special_tokens=True
        )
        i = 0
        while i < L:
            if special[i] or toks[i].startswith("##"):
                i += 1
                continue
            # gather the whole word (this piece + following ## pieces)
            j = i + 1
            word = toks[i]
            while j < L and toks[j].startswith("##") and not special[j]:
                word += toks[j][2:]
                j += 1
            word_start[b, i] = True
            if word in ent2id and rng.random() < pivot_probability:
                labels[b, i] = ent2id[word]
            i = j
    return labels, word_start


def random_erase(
    frames: np.ndarray,
    patch_size: int,
    s_l: float = 0.3,
    s_h: float = 0.5,
    r_1: float = 0.3,
    r_2: float = 1 / 0.3,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """frames: (T, H, W, C). Returns (crop, patch_mask, context):

      crop    — only the erased rectangle kept, rest zeroed (the teacher input);
      mask    — (H/p, W/p) float grid, 0 inside the erased region, 1 outside;
      context — rectangle zeroed out, rest kept (the complement view).

    Rectangle area ∈ [s_l, s_h]·H·W with aspect ∈ [r_1, r_2]; position and
    size snapped down to the patch grid.
    """
    rng = rng or np.random.default_rng()
    T, H, W, C = frames.shape
    while True:
        s = rng.uniform(s_l, s_h) * H * W
        r = rng.uniform(r_1, r_2)
        w = int(np.sqrt(s / r))
        h = int(np.sqrt(s * r))
        left = int(rng.integers(0, W))
        top = int(rng.integers(0, H))
        w -= w % patch_size
        h -= h % patch_size
        left -= left % patch_size
        top -= top % patch_size
        if left + w <= W and top + h <= H and w > 0 and h > 0:
            break

    context = frames.copy()
    context[:, top : top + h, left : left + w, :] = 0

    crop = np.zeros_like(frames)
    crop[:, top : top + h, left : left + w, :] = frames[
        :, top : top + h, left : left + w, :
    ]

    mask = np.ones((H // patch_size, W // patch_size), dtype=np.float32)
    mask[
        top // patch_size : (top + h) // patch_size,
        left // patch_size : (left + w) // patch_size,
    ] = 0.0
    return crop, mask, context
