"""Datasets and collators of retrieval and video QA, for finetuning and eval.

The port's counterpart of ``alpro_tpu/data/datasets.py``'s retrieval and QA
half: annotation jsonl/json files with {vid_id, txt} rows, decode with retry
(a failed training decode resamples another example), the retrieval
training pairs (frames sampled by ``frm_sampling_strategy``, a random square
crop, one caption drawn from a list), the retrieval eval protocol's video
iteration over the full text bank (with a zero clip for a video that fails
to decode, so the id→score protocol stays whole), the QA dataset
(open-ended and multi-choice; ``is_train`` gives the training split's
sampling and random crops) and the collators that tokenize. Every draw comes
from the dataset's ``ThreadSafeRng``, in the JAX module's order. Batches are
plain numpy dicts; the pixels are normalized on the device inside the model.

Not ported (ROADMAP A17/A11): the pretraining datasets, the pretrain
collator, MLM masking and random erase, RandAugment, ``mk_input_group``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from alpro_tpu_torch.data.rng import ThreadSafeRng
from alpro_tpu_torch.data.transforms import (
    center_square_crop,
    random_square_crop,
    resize_shorter_side,
)
from alpro_tpu_torch.media import read_video


def load_jsonl(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(l) for l in f if l.strip()]


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_datalist(path: str) -> List[dict]:
    """Annotation loader: .jsonl rows or .json lists; rows normalize to
    {vid_id, txt, ...}. The pandas ``.pkl`` WebVid datalists of pretraining
    are not read (ROADMAP A11)."""
    if path.endswith(".jsonl"):
        return [_normalize_row(r) for r in load_jsonl(path)]
    if path.endswith(".json"):
        data = load_json(path)
        assert isinstance(data, list), f"{path} must hold a list of rows"
        return [_normalize_row(r) for r in data]
    if path.endswith(".pkl"):
        raise NotImplementedError(
            f"{path}: pandas .pkl datalists (WebVid pretraining) are not read "
            "by the port yet (ROADMAP A11)"
        )
    raise ValueError(f"unsupported annotation format: {path}")


_ID_KEYS = ("vid_id", "video_id", "videoid", "id", "image_id", "clip_id")
_TXT_KEYS = ("txt", "caption", "name", "text", "sentence")


def _normalize_row(row: dict) -> dict:
    out = dict(row)
    if "vid_id" not in out:
        for k in _ID_KEYS:
            if k in out:
                out["vid_id"] = str(out[k])
                break
    if "txt" not in out:
        for k in _TXT_KEYS:
            if k in out:
                out["txt"] = out[k]
                break
    return out


def _find_video(vid_dir: str, vid_id: str) -> Optional[str]:
    for ext in (".npy", ".npz", ".mp4", ".webm", ".avi", ".mkv", ""):
        p = os.path.join(vid_dir, f"{vid_id}{ext}")
        if os.path.exists(p):
            return p
    return None


class VideoDatasetBase:
    """Decode + resize + crop with retry-on-failure resampling."""

    def __init__(
        self,
        datalist: List[dict],
        vid_dir: str,
        num_frm: int = 8,
        frm_sampling_strategy: str = "uniform",
        resize_size: int = 256,
        crop_size: int = 224,
        is_train: bool = True,
        max_retries: int = 5,
        seed: int = 0,
        backend=None,
        fps: float = -1,
    ):
        self.datalist = datalist
        self.vid_dir = vid_dir
        self.num_frm = num_frm
        self.frm_sampling_strategy = frm_sampling_strategy
        self.resize_size = resize_size
        self.crop_size = crop_size
        self.is_train = is_train
        self.max_retries = max_retries
        self.rng = ThreadSafeRng(seed)  # per-thread under BatchLoader workers
        self.backend = backend
        self.fps = fps  # used only for timestamp-windowed rows

    def __len__(self) -> int:
        return len(self.datalist)

    @staticmethod
    def _row_window(item: Optional[dict]) -> tuple:
        """Per-row decode window: rows may carry `ts: [start, end]` (seconds,
        DiDeMo-style moments) or explicit `start_time`/`end_time` fields."""
        if not item:
            return None, None
        ts = item.get("ts")
        if ts:
            return float(ts[0]), float(ts[1])
        return item.get("start_time"), item.get("end_time")

    def _load_clip(self, vid_id: str, item: Optional[dict] = None) -> Optional[np.ndarray]:
        path = _find_video(self.vid_dir, vid_id)
        if path is None:
            return None
        strategy = self.frm_sampling_strategy if self.is_train else "uniform"
        start_time, end_time = self._row_window(item)
        clip = read_video(
            path, self.num_frm, strategy, self.rng, backend=self.backend,
            start_time=start_time, end_time=end_time, fps=self.fps,
        )
        if clip is None:
            return None
        clip = resize_shorter_side(clip, self.resize_size)
        if self.is_train:
            clip = random_square_crop(clip, self.crop_size, self.rng)
        else:
            clip = center_square_crop(clip, self.crop_size)
        if clip.shape[0] < self.num_frm:  # short video: pad by repeating last
            pad = np.repeat(clip[-1:], self.num_frm - clip.shape[0], axis=0)
            clip = np.concatenate([clip, pad], axis=0)
        return clip

    def get_with_retry(self, index: int) -> Dict:
        """Decode failure → a random other example (the reference's
        fault-tolerance idiom)."""
        for _ in range(self.max_retries):
            item = self.datalist[index]
            clip = self._load_clip(item["vid_id"], item)
            if clip is not None:
                return dict(item, clip=clip)
            index = int(self.rng.integers(0, len(self.datalist)))
        raise RuntimeError(
            f"failed to decode any video after {self.max_retries} retries"
        )


class RetrievalDataset(VideoDatasetBase):
    """Training rows {vid_id, txt}: one (clip, caption) example per row; a
    ``txt`` list gives one caption drawn at random in training (the first in
    eval)."""

    def __getitem__(self, index: int) -> Dict:
        ex = self.get_with_retry(index)
        txt = ex["txt"]
        if isinstance(txt, list):
            txt = txt[int(self.rng.integers(0, len(txt)))] if self.is_train else txt[0]
        return {"vid_id": ex["vid_id"], "caption": txt, "clip": ex["clip"]}


class RetrievalEvalDataset(VideoDatasetBase):
    """MSRVTT 1k protocol: every text scored against every video; iterates
    videos, exposing the full text bank."""

    def __init__(self, datalist, vid_dir, **kw):
        super().__init__(datalist, vid_dir, is_train=False, **kw)
        self.texts = [
            {"txt_id": d.get("txt_id", i), "caption": d["txt"], "vid_id": d["vid_id"]}
            for i, d in enumerate(datalist)
        ]
        seen, vids = set(), []
        for d in datalist:
            if d["vid_id"] not in seen:
                seen.add(d["vid_id"])
                vids.append(d["vid_id"])
        self.video_ids = vids
        # first row per video defines its decode window (ts rows)
        self._vid_row = {}
        for d in datalist:
            self._vid_row.setdefault(d["vid_id"], d)
        self.gt_txt_id2vid_id = {t["txt_id"]: t["vid_id"] for t in self.texts}

    def __len__(self) -> int:
        return len(self.video_ids)

    def get_video(self, index: int) -> Dict:
        """Eval decode with fault tolerance: retry the same video, then fall
        back to a zero clip. Eval keeps the id→score protocol intact, so the
        video id is never substituted — one corrupt video scores as blank
        instead of killing the whole run."""
        vid_id = self.video_ids[index]
        clip = None
        for _ in range(3):
            clip = self._load_clip(vid_id, self._vid_row.get(vid_id))
            if clip is not None:
                break
        if clip is None:
            logging.getLogger("alpro_tpu_torch").warning(
                "failed to decode eval video %s; scoring a zero clip", vid_id
            )
            clip = np.zeros(
                (self.num_frm, self.crop_size, self.crop_size, 3), np.uint8
            )
        return {"vid_id": vid_id, "clip": clip}


MULTI_CHOICE_QA = ("action", "transition")


class VideoQADataset(VideoDatasetBase):
    """Open-ended rows: {question_id, question, answer, answer_type, vid_id};
    multi-choice (TGIF action/transition) rows additionally carry `options`
    (list of n_options strings) and an integer `answer` option index."""

    def __init__(self, datalist, vid_dir, ans2label: Dict[str, int],
                 return_label: bool = True, task_type: str = "msrvtt_qa",
                 **kw):
        super().__init__(datalist, vid_dir, **kw)
        self.ans2label = ans2label
        self.label2ans = {v: k for k, v in ans2label.items()}
        self.return_label = return_label
        self.task_type = task_type
        self.qid2data = {
            d["question_id"]: d for d in datalist
        }

    def __getitem__(self, index: int) -> Dict:
        ex = self.get_with_retry(index)
        out = {
            "question_id": ex["question_id"],
            "question": ex["question"],
            "clip": ex["clip"],
        }
        if self.task_type in MULTI_CHOICE_QA:
            out["options"] = list(ex["options"])
            if self.return_label:
                out["label"] = int(ex["answer"])
        elif self.return_label:
            # KeyError on out-of-vocab answers: a mismatched ans2label file
            # must fail loudly
            out["label"] = self.ans2label[ex["answer"]]
        return out

    def evaluate_qa(self, results):
        from alpro_tpu_torch.evals.qa import evaluate_qa

        return evaluate_qa(
            results, self.qid2data, self.label2ans,
            task_type=getattr(self, "task_type", "msrvtt_qa"),
        )


# --------------------------------------------------------------------------
# collators
# --------------------------------------------------------------------------
def _maybe_patchify(clips: np.ndarray, patchify: bool, patch_size: int) -> np.ndarray:
    """Optionally repack (B, T, H, W, C) uint8 into the patch-major
    (B, T, N, p·p·C) layout (rows in (ph, pw, c) order), in numpy."""
    if not patchify:
        return clips
    B, T, H, W, C = clips.shape
    p = patch_size
    v = clips.reshape(B, T, H // p, p, W // p, p, C)
    return np.ascontiguousarray(
        v.transpose(0, 1, 2, 4, 3, 5, 6)
    ).reshape(B, T, (H // p) * (W // p), p * p * C)


class RetrievalCollator:
    def __init__(self, tokenizer, max_txt_len: int = 40,
                 patchify: bool = False, patch_size: int = 16):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.patchify = patchify
        self.patch_size = patch_size

    def __call__(self, examples: Sequence[dict]) -> Dict[str, np.ndarray]:
        enc = self.tokenizer(
            [e["caption"] for e in examples], max_length=self.max_txt_len,
        )
        clips = np.stack([e["clip"] for e in examples])
        return {
            "visual_inputs": _maybe_patchify(clips, self.patchify, self.patch_size),
            "text_input_ids": np.asarray(enc["input_ids"], np.int32),
            "text_input_mask": np.asarray(enc["attention_mask"], np.int32),
        }


class QACollator:
    """Open-ended: one text row per question. Multi-choice (action/
    transition): question and each option concatenate into one sequence —
    (B·n_options) text rows against B videos, the logits regrouped
    downstream (the video tokens repeat per option in
    ``serving/inference.py::qa_logits``)."""

    def __init__(self, tokenizer, max_txt_len: int = 40, return_label=True,
                 task_type: str = "msrvtt_qa", n_options: int = 5):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.return_label = return_label
        self.task_type = task_type
        self.n_options = n_options

    def __call__(self, examples: Sequence[dict]) -> Dict[str, np.ndarray]:
        if self.task_type in MULTI_CHOICE_QA:
            texts = []
            for e in examples:
                opts = e["options"]
                assert len(opts) == self.n_options, (
                    f"expected {self.n_options} options, got {len(opts)}"
                )
                texts.extend(e["question"] + " " + o for o in opts)
        else:
            texts = [e["question"] for e in examples]
        enc = self.tokenizer(texts, max_length=self.max_txt_len)
        out = {
            "visual_inputs": np.stack([e["clip"] for e in examples]),
            "text_input_ids": np.asarray(enc["input_ids"], np.int32),
            "text_input_mask": np.asarray(enc["attention_mask"], np.int32),
            "question_ids": [e["question_id"] for e in examples],
        }
        if self.return_label and "label" in examples[0]:
            out["labels"] = np.asarray([e["label"] for e in examples], np.int32)
        return out
