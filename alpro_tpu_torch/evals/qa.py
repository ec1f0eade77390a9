"""Video QA evaluation: overall and per-answer-type accuracy, and the
multi-clip logit pooling.

The port's own copy of ``alpro_tpu/evals/qa.py``: ``evaluate_qa`` (ALPRO's
open-ended accuracy with its answer types) and ``pool_clip_logits`` (the
mean / max / lse ensembling of per-clip logits), on numpy.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

ANSWER_TYPES = {
    "frameqa": {"object": 0, "number": 1, "color": 2, "location": 3},
    "msrvtt_qa": {k: i for i, k in enumerate(["what", "who", "how", "where", "when"])},
    "msvd_qa": {k: i for i, k in enumerate(["what", "who", "how", "where", "when"])},
}
OPEN_ENDED = ("msrvtt_qa", "msvd_qa", "frameqa")


def pool_clip_logits(logits: np.ndarray, method: str = "mean") -> np.ndarray:
    """(num_clips, B, L) per-clip logits → (B, L)."""
    if method == "mean":
        return logits.mean(axis=0)
    if method == "max":
        return logits.max(axis=0)
    if method == "lse":
        m = logits.max(axis=0, keepdims=True)
        return np.log(np.exp(logits - m).sum(axis=0)) + m[0]
    raise ValueError(f"invalid pool method {method!r}")


def evaluate_qa(
    results: Sequence[dict],
    qid2data: Dict,
    label2ans: Dict[int, str] = None,
    task_type: str = "msrvtt_qa",
) -> Dict[str, float]:
    """results: [{question_id, answer(label idx)}]; qid2data: ground truth with
    'answer' (str) and 'answer_type'."""
    qid2pred = {r["question_id"]: r["answer"] for r in results}
    if task_type in OPEN_ENDED and label2ans is not None:
        qid2pred = {k: label2ans[v] for k, v in qid2pred.items()}

    preds, gts, ans_types = [], [], []
    type_map = ANSWER_TYPES.get(task_type, {})
    for qid, pred in qid2pred.items():
        gt = qid2data[qid]
        preds.append(pred)
        gts.append(gt["answer"])
        if task_type in OPEN_ENDED:
            # one entry per row, -1 for missing/unknown types, so the
            # per-type masks below stay aligned with preds/gts even on
            # partially annotated datasets
            ans_types.append(type_map.get(gt.get("answer_type"), -1))

    preds = np.asarray(preds)
    gts = np.asarray(gts)
    metrics: Dict[str, float] = {"overall_acc": float(np.mean(preds == gts))}
    if ans_types and max(ans_types) >= 0:
        ans_types = np.asarray(ans_types)
        ratios = {}
        for name, idx in type_map.items():
            m = ans_types == idx
            corr = preds[m] == gts[m]
            metrics[f"{name}_acc"] = float(np.mean(corr)) if len(corr) else 0.0
            ratios[f"{name}_ratio"] = [len(corr) / len(ans_types), int(len(corr))]
        metrics["ratios"] = ratios
    return metrics
