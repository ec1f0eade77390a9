"""Model FLOPs of ALPRO's pretraining step from shapes (``counts/model.py``'s
rules: two FLOPs a multiply-add, the linear layers and the attentions, no
recomputation; the prompt banks are set-up and not counted).

A clip's student forward: the video tower and ``vision_proj``; the text half
and ``text_proj``; VTM's fusion over three rows a clip (the positive and the
two hard negatives) and the ITM head; MLM's second text half and fusion and
the MLM head (dense, then the decoder to the vocabulary) over the text
rows; the MPM head (768 → 1536 → entities). Trained: 3 × that forward. The
frozen teacher adds its tower and ``vision_proj`` over the erased crop,
forward only."""

from __future__ import annotations

from perfbench.counts.model import bert_layers, projection, timesformer_forward


def student_forward(frames: int, text_len: int, vocab: int = 30522, entities: int = 1000,
                    video_tokens: int = 197, dim: int = 768) -> float:
    tower = timesformer_forward(frames) + projection()
    text = bert_layers(text_len, 6) + projection()
    fusion = bert_layers(text_len + video_tokens, 6)
    vtm = 3 * (fusion + 2 * dim * 2)
    mlm = bert_layers(text_len, 6) + fusion + text_len * (2 * dim * dim + 2 * dim * vocab)
    mpm = 2 * dim * 2 * dim + 2 * 2 * dim * entities
    return tower + text + vtm + mlm + mpm


def teacher_forward(frames: int) -> float:
    return timesformer_forward(frames) + projection()


def pretrain_clip(frames: int, text_len: int, vocab: int = 30522, entities: int = 1000) -> float:
    """One clip of a pretraining step: the student trained, the teacher's
    forward of its crop."""
    return 3 * student_forward(frames, text_len, vocab, entities) + teacher_forward(frames)
