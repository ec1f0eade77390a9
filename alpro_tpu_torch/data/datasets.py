"""Datasets and collators of retrieval, video QA and pretraining.

The port's counterpart of ``alpro_tpu/data/datasets.py``: annotation
jsonl/json files with {vid_id, txt} rows, decode with retry
(a failed training decode resamples another example), the retrieval
training pairs (frames sampled by ``frm_sampling_strategy``, a random square
crop, one caption drawn from a list), the retrieval eval protocol's video
iteration over the full text bank (with a zero clip for a video that fails
to decode, so the id→score protocol stays whole), the QA dataset
(open-ended and multi-choice; ``is_train`` gives the training split's
sampling and random crops), the pretraining datasets (WebVid-style clips
with the temporally consistent RandAugment, CC3M-style ``.npy`` images
through ``random_resized_crop``, ``random_hflip`` and RandAugment, repeated
to ``num_frm`` frames), the collators that tokenize and ``PretrainCollator``,
which adds the MLM ids and labels and the random-erase views of MPM. Every
draw comes from the dataset's or the collator's ``ThreadSafeRng``, in the
JAX module's order. Batches are plain numpy dicts; the pixels are
normalized on the device inside the model.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from alpro_tpu_torch.data.masking import mask_batch_text_tokens, random_erase
from alpro_tpu_torch.data.randaugment import RandomAugment, TemporalConsistentRandomAugment
from alpro_tpu_torch.data.rng import ThreadSafeRng
from alpro_tpu_torch.data.transforms import (
    center_square_crop,
    random_hflip,
    random_resized_crop,
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
    {vid_id, txt, ...}. The pandas ``.pkl`` WebVid datalists are not read:
    pandas is not a dependency of the port (ROADMAP A17)."""
    if path.endswith(".jsonl"):
        return [_normalize_row(r) for r in load_jsonl(path)]
    if path.endswith(".json"):
        data = load_json(path)
        assert isinstance(data, list), f"{path} must hold a list of rows"
        return [_normalize_row(r) for r in data]
    if path.endswith(".pkl"):
        raise NotImplementedError(
            f"{path}: pandas .pkl datalists (WebVid pretraining) are not read "
            "by the port yet (ROADMAP A17); convert the rows to .jsonl"
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


def mk_input_group(key_txt_pairs: Sequence[tuple], max_n_example_per_group: int = 2,
                   is_train: bool = True,
                   rng: Optional[np.random.Generator] = None) -> List[tuple]:
    """Group (key, example) pairs by key into chunks of at most
    ``max_n_example_per_group`` (training: each key's examples shuffled
    first); eval keeps one example per group."""
    rng = rng or np.random.default_rng()
    by_key: Dict = {}
    for k, ex in key_txt_pairs:
        by_key.setdefault(k, []).append(ex)
    groups: List[tuple] = []
    for k, examples in by_key.items():
        if is_train:
            examples = list(examples)
            rng.shuffle(examples)
            for start in range(0, len(examples), max_n_example_per_group):
                groups.append((k, examples[start: start + max_n_example_per_group]))
        else:
            groups.extend((k, [ex]) for ex in examples)
    n_in, n_out = len(key_txt_pairs), sum(len(exs) for _, exs in groups)
    if n_in != n_out:
        raise AssertionError(f"group-by dropped examples: {n_in} -> {n_out}")
    return groups


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


class PretrainVideoDataset(VideoDatasetBase):
    """WebVid-style (video, caption) rows. Training applies the temporally
    consistent RandAugment (N 2, M 5) after the crop."""

    def __init__(self, *args, use_randaug: bool = True, **kw):
        super().__init__(*args, **kw)
        self.randaug = None
        if use_randaug and self.is_train:
            self.randaug = TemporalConsistentRandomAugment(N=2, M=5, rng=self.rng)

    def __getitem__(self, index: int) -> Dict:
        ex = self.get_with_retry(index)
        clip = ex["clip"]
        if self.randaug is not None:
            clip = self.randaug(clip)
        return {"caption": ex["txt"], "clip": clip, "type": "video"}


class PretrainImageDataset:
    """CC3M-style (image, caption) rows, each image a ``.npy``/``.npz``
    array (H, W, 3), or (T, H, W, 3) of which the first frame is taken.
    Training: ``random_resized_crop`` (bicubic) → ``random_hflip`` →
    RandAugment (N 2, M 7, ``IMAGE_AUGS``), then the image repeated to
    ``num_frm`` frames; eval: repeated, resized and centre-cropped. A row
    that fails to load is replaced by a random other, up to 5 tries."""

    IMAGE_AUGS = ["Identity", "Brightness", "Sharpness", "ShearX", "ShearY",
                  "TranslateX", "TranslateY", "Rotate"]

    def __init__(self, datalist, img_dir, num_frm=4, resize_size=256,
                 crop_size=224, seed=0, is_train=True, use_randaug=True):
        self.datalist = datalist
        self.img_dir = img_dir
        self.num_frm = num_frm
        self.resize_size = resize_size
        self.crop_size = crop_size
        self.is_train = is_train
        self.rng = ThreadSafeRng(seed)  # per-thread under BatchLoader workers
        self.randaug = None
        if is_train and use_randaug:
            self.randaug = RandomAugment(N=2, M=7, augs=self.IMAGE_AUGS, rng=self.rng)

    def __len__(self):
        return len(self.datalist)

    @staticmethod
    def _load(path: str) -> Optional[np.ndarray]:
        if not path.endswith((".npy", ".npz")):
            raise NotImplementedError(
                f"{path}: only .npy/.npz images are read by the port; decoding image "
                "files is the media binding's work (ROADMAP A17)")
        try:  # a corrupt or short file is replaced by another row
            arr = np.load(path)
            img = arr["frames"] if hasattr(arr, "files") else arr
            return img[0] if img.ndim == 4 else img
        except Exception:
            return None

    def __getitem__(self, index: int) -> Dict:
        for _ in range(5):
            item = self.datalist[index]
            path = _find_video(self.img_dir, item["vid_id"])
            img = None if path is None else self._load(path)
            if img is not None:
                if self.is_train:
                    img = random_resized_crop(img, self.crop_size, self.rng)
                    img = random_hflip(img, self.rng)
                    if self.randaug is not None:
                        img = self.randaug(np.ascontiguousarray(img))
                    frames = np.repeat(img[None], self.num_frm, axis=0)
                else:
                    frames = np.repeat(img[None], self.num_frm, axis=0)
                    frames = resize_shorter_side(frames, self.resize_size)
                    frames = center_square_crop(frames, self.crop_size)
                return {"caption": item["txt"], "clip": frames, "type": "image"}
            index = int(self.rng.integers(0, len(self.datalist)))
        raise RuntimeError("failed to load any image")


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


class PretrainCollator:
    """Tokenize, then BERT MLM masking (``mlm_text_input_ids``,
    ``mlm_labels``) and the MPM random-erase views of every clip
    (``crop_visual_inputs``, ``mpm_mask``, ``context_visual_inputs``), drawn
    from the collator's ``ThreadSafeRng``; ``type`` is the first example's
    (``video`` or ``image``)."""

    def __init__(self, tokenizer, max_txt_len=30, mlm: bool = True,
                 mpm: bool = True, patch_size: int = 16, seed: int = 0):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.mlm = mlm
        self.mpm = mpm
        self.patch_size = patch_size
        self.rng = ThreadSafeRng(seed)  # per-thread under BatchLoader workers

    def __call__(self, examples: Sequence[dict]) -> Dict[str, np.ndarray]:
        enc = self.tokenizer([e["caption"] for e in examples], max_length=self.max_txt_len)
        ids = np.asarray(enc["input_ids"], np.int32)
        mask = np.asarray(enc["attention_mask"], np.int32)
        clips = np.stack([e["clip"] for e in examples])
        batch = {
            "visual_inputs": clips,
            "text_input_ids": ids,
            "text_input_mask": mask,
            "type": examples[0].get("type", "video"),
        }
        if self.mlm:
            masked_ids, labels = mask_batch_text_tokens(ids, self.tokenizer, rng=self.rng)
            batch["mlm_text_input_ids"] = masked_ids.astype(np.int32)
            batch["mlm_labels"] = labels.astype(np.int32)
        if self.mpm:
            views = [random_erase(clip, self.patch_size, rng=self.rng) for clip in clips]
            batch["crop_visual_inputs"] = np.stack([v[0] for v in views])
            batch["mpm_mask"] = np.stack([v[1] for v in views])
            batch["context_visual_inputs"] = np.stack([v[2] for v in views])
        return batch
