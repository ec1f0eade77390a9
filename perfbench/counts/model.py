"""Model FLOPs of ALPRO-base from shapes: what the algorithm needs, two
FLOPs a multiply-add, recomputation not counted.

A linear layer of (din → dout) over r rows is 2·r·din·dout; an attention
over q queries and k keys of width d (all heads) is 4·q·k·d (scores and
P·V). Softmax, LayerNorm, GELU and adds are left out (they are under 1% of
a tower's FLOPs at these widths)."""

from __future__ import annotations


def timesformer_forward(frames: int, patches: int = 196, dim: int = 768, mlp: int = 3072,
                        depth: int = 12, patch_in: int = 768) -> float:
    """One clip through TimeSformer with divided space-time attention: the
    patch embedding, then per block the temporal branch (qkv, attention over
    the frames at each patch, proj, temporal_fc), the spatial branch (qkv,
    attention over [cls; patches] per frame, proj) and the MLP over the
    patches and the CLS."""
    t, n, d = frames, patches, dim
    tokens = t * n
    temporal = 2 * tokens * d * 3 * d + 4 * n * t * t * d + 2 * tokens * d * d * 2
    spatial = 2 * t * (n + 1) * d * 3 * d + 4 * t * (n + 1) ** 2 * d + 2 * t * (n + 1) * d * d
    mlp_ = 2 * (tokens + 1) * d * mlp * 2
    return 2 * tokens * patch_in * d + depth * (temporal + spatial + mlp_)


def bert_layers(seq: int, layers: int, dim: int = 768, mlp: int = 3072) -> float:
    """``layers`` post-LN BERT layers over one sequence of ``seq`` tokens."""
    per = 2 * seq * dim * dim * 4 + 4 * seq * seq * dim + 2 * seq * dim * mlp * 2
    return layers * per


def projection(dim: int = 768, out: int = 256) -> float:
    return 2 * dim * out


def ingest_clip(frames: int) -> float:
    """One clip of ``add_videos``: the tower and ``vision_proj``."""
    return timesformer_forward(frames) + projection()


def query(text_len: int, gallery: int, topk: int, video_tokens: int = 197) -> float:
    """One ``RetrievalIndex.query``: the text half and ``text_proj``, the VTC
    similarity against the gallery, and the fusion half and ITM head over
    the top-k pairs."""
    text = bert_layers(text_len, 6) + projection()
    vtc = 2 * 256 * gallery
    fusion = topk * (bert_layers(text_len + video_tokens, 6) + 2 * 768 * 2)
    return text + vtc + fusion


def qa_forward(frames: int, text_len: int, labels: int, video_tokens: int = 197,
               dim: int = 768, hidden_scale: int = 2) -> float:
    """One QA example forward: the tower, the text half, the fusion half
    and the MLP classifier."""
    h = dim * hidden_scale
    return (timesformer_forward(frames) + bert_layers(text_len, 6)
            + bert_layers(text_len + video_tokens, 6) + 2 * dim * h + 2 * h * labels)


def qa_train_clip(frames: int, text_len: int, labels: int) -> float:
    """One QA example trained: 3 × forward (backward as twice the forward);
    the checkpointed tower's recompute is not counted."""
    return 3 * qa_forward(frames, text_len, labels)
