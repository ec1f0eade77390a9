"""Model FLOPs of ALPRO's retrieval finetuning step from shapes
(``counts/model.py``'s rules): a clip's forward is the video tower and
``vision_proj``, the text half and ``text_proj``, and VTM's fusion over three
rows a clip (the positive and the two hard negatives) with the ITM head;
trained, 3 × that forward. The gathers and the all-reduce move bytes, not
FLOPs."""

from __future__ import annotations

from perfbench.counts.model import bert_layers, projection, timesformer_forward


def retrieval_train_clip(frames: int, text_len: int, video_tokens: int = 197,
                         dim: int = 768) -> float:
    forward = (timesformer_forward(frames) + projection() + bert_layers(text_len, 6)
               + projection() + 3 * (bert_layers(text_len + video_tokens, 6) + 2 * dim * 2))
    return 3 * forward
