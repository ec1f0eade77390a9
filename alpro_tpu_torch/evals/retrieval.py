"""Text↔video retrieval evaluation protocol (the port's copy of
``alpro_tpu/evals/retrieval.py``).

ALPRO's `run_video_retrieval.py` eval: the ranking score for each (text, video) pair is the VTM head's P(match)
softmax probability (its VTM head), with the VTC similarity carried alongside;
metrics are R@1/5/10, median rank and mean rank in both directions.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np


def retrieval_metrics_from_matrix(
    score_matrix: np.ndarray, gt_cols: np.ndarray
) -> Dict[str, float]:
    """score_matrix: (num_q, num_c); gt_cols[i] = ground-truth column of row i.

    Rank = position of the GT column when the row is sorted descending
    (1-indexed), exactly the bool-matrix construction of
    `run_video_retrieval.py:516-558`.
    """
    num_q = score_matrix.shape[0]
    order = np.argsort(-score_matrix, axis=1, kind="stable")
    ranks = np.empty(num_q, dtype=np.int64)
    for i in range(num_q):
        ranks[i] = int(np.where(order[i] == gt_cols[i])[0][0]) + 1
    return dict(
        r1=100.0 * float(np.mean(ranks <= 1)),
        r5=100.0 * float(np.mean(ranks <= 5)),
        r10=100.0 * float(np.mean(ranks <= 10)),
        medianR=float(np.median(ranks)),
        meanR=float(np.mean(ranks)),
    )


def eval_retrieval(
    vid_txt_score_dicts: Sequence[dict],
    gt_txt_id2vid_id: Dict,
    id2data: Dict = None,
) -> Dict[str, Dict[str, float]]:
    """Same I/O contract as the reference `eval_retrieval`
    (`run_video_retrieval.py:559-629`): a list of
    {vid_id, txt_id, score, sim} pair dicts → text2video + video2text metrics.
    Duplicate (txt, vid) pairs are dropped keeping the first occurrence."""
    by_txt: Dict = defaultdict(dict)
    for d in vid_txt_score_dicts:
        if d["vid_id"] not in by_txt[d["txt_id"]]:
            by_txt[d["txt_id"]][d["vid_id"]] = d

    txt_ids = list(by_txt.keys())
    any_txt = txt_ids[0]
    vid_ids = list(by_txt[any_txt].keys())
    num_vid = len(vid_ids)
    assert len(set(vid_ids)) == num_vid, "duplicate videos for a caption"
    for t, pairs in by_txt.items():
        assert len(pairs) == num_vid, "every caption must score every video"

    txt_id2idx = {t: i for i, t in enumerate(txt_ids)}
    vid_id2idx = {v: i for i, v in enumerate(vid_ids)}

    score = np.zeros((len(txt_ids), num_vid), dtype=np.float32)
    for t, pairs in by_txt.items():
        for v, d in pairs.items():
            score[txt_id2idx[t], vid_id2idx[v]] = d["score"]

    t2v_gt = np.asarray(
        [vid_id2idx[gt_txt_id2vid_id[t]] for t in txt_ids], dtype=np.int64
    )
    t2v = retrieval_metrics_from_matrix(score, t2v_gt)

    gt_vid2txts: Dict = defaultdict(list)
    for t, v in gt_txt_id2vid_id.items():
        gt_vid2txts[v].append(t)
    # v2t ranks only videos that are SOME text's ground truth (a video with
    # no gt caption has no defined rank). The reference's eval sets always
    # have one caption per video, so this filter never drops a row there;
    # synthetic or debug-trimmed subsets can have caption-less videos.
    vids_w_gt = [v for v in vid_ids if gt_vid2txts[v]]
    rows = np.asarray([vid_id2idx[v] for v in vids_w_gt], dtype=np.int64)
    if all(len(gt_vid2txts[v]) == 1 for v in vids_w_gt):
        # 1:1 protocol (MSRVTT-1k, DiDeMo paragraph retrieval) — identical
        # to the reference's inversion (`run_video_retrieval.py:559-629`)
        v2t_gt = np.asarray(
            [txt_id2idx[gt_vid2txts[v][0]] for v in vids_w_gt], dtype=np.int64
        )
        v2t = retrieval_metrics_from_matrix(score.T[rows], v2t_gt)
    else:
        # multi-caption protocol (MSRVTT full split: 20 captions/video):
        # a video's rank is the BEST rank among its ground-truth captions —
        # the standard v2t convention the reference never needed (its eval
        # sets are all 1:1). t2v above is unchanged (each caption still has
        # exactly one ground-truth video).
        v2t = retrieval_metrics_multi_gt(
            score.T[rows],
            [[txt_id2idx[t] for t in gt_vid2txts[v]] for v in vids_w_gt],
        )
    return dict(text2video=t2v, video2text=v2t)


def retrieval_metrics_multi_gt(
    score_matrix: np.ndarray, gt_cols: List[List[int]]
) -> Dict[str, float]:
    """Best-rank-over-candidates metrics: row i's rank is the highest-placed
    (minimum 1-indexed position) of ANY of its ground-truth columns in the
    descending sort of the row. Reduces to `retrieval_metrics_from_matrix`
    when every row has exactly one ground-truth column."""
    num_q = score_matrix.shape[0]
    order = np.argsort(-score_matrix, axis=1, kind="stable")
    ranks = np.empty(num_q, dtype=np.int64)
    for i in range(num_q):
        pos = np.where(np.isin(order[i], np.asarray(gt_cols[i])))[0]
        assert pos.size == len(gt_cols[i]), "ground-truth column missing"
        ranks[i] = int(pos.min()) + 1
    return dict(
        r1=100.0 * float(np.mean(ranks <= 1)),
        r5=100.0 * float(np.mean(ranks <= 5)),
        r10=100.0 * float(np.mean(ranks <= 10)),
        medianR=float(np.median(ranks)),
        meanR=float(np.mean(ranks)),
    )
