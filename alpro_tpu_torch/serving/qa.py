"""Video QA serving: (clips, question) → ranked answers.

Counterpart of ``alpro_tpu/serving/qa.py::VideoQAPredictor`` (open-ended
MSRVTT-QA / MSVD-QA): encode the sampled clip(s), run question + fusion +
classifier, pool the per-clip logits with the reference's multi-clip
ensembling (mean / max / lse, ``evals/qa.py``), and map label ids back to
answer strings. ``encode_video`` caches the video-tower output on the
device, so many questions about one video pay only text + fusion + head.

One change from the JAX class: ``predict`` and ``predict_batch`` tokenize
each question once and repeat its rows per clip, instead of one tokenizer
call per (question, clip) pair.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from alpro_tpu_torch.evals.qa import pool_clip_logits
from alpro_tpu_torch.ops.quant import quantize_tree
from alpro_tpu_torch.serving.inference import make_qa_inference_fn, make_qa_video_encode_fn

Answer = Tuple[str, float]  # (answer, probability)


class VideoQAPredictor:
    """>>> qa = VideoQAPredictor(model, tokenizer, ans2label, "cuda")
    >>> qa.predict(clips_uint8, "what is the man doing", topk=3)
    [("cooking", 0.71), ("eating", 0.12), ("running", 0.05)]

    Many questions on one video — encode once, ask cheaply:
    >>> feats = qa.encode_video(clips_uint8)
    >>> qa.predict(feats, "who is on the stage")
    """

    def __init__(self, model, tokenizer, ans2label: Dict[str, int], device="cuda",
                 max_txt_len: int = 25, pool: str = "mean", weights: str = "bf16"):
        """``model`` (built by ``build_qa_model``) must already live on
        ``device``. ``weights``: 'bf16' serves the model's weights as they
        are; 'int8' serves a copy with per-channel int8 weight storage,
        dequantized as each call reads them (``ops/quant.py::quantize_tree``;
        ``model`` itself is unchanged)."""
        if weights not in ("bf16", "int8"):
            raise ValueError(f"weights must be 'bf16' or 'int8', got {weights!r}")
        if weights == "int8":
            model = quantize_tree(model)
        self.model = model
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.max_txt_len = int(max_txt_len)
        self.pool = pool
        self.label2ans = {v: k for k, v in ans2label.items()}
        self._infer = make_qa_inference_fn(model)
        self._encode = make_qa_video_encode_fn(model)

    def encode_video(self, clips) -> torch.Tensor:
        """(n_clips, T, H, W, 3) uint8 (numpy or tensor) → device-resident
        (n_clips, 1+N, D) video tokens. Pass the result to ``predict`` in
        place of ``clips`` to skip the video tower on later questions."""
        clips = torch.as_tensor(clips)
        if clips.dim() != 5:
            raise ValueError(f"clips must be (n_clips, T, H, W, 3), got {tuple(clips.shape)}")
        return self._encode(clips.to(self.device))

    def _tokens(self, questions: Sequence[str], n: int):
        """Each question tokenized once, its rows repeated per clip:
        row b·n + j = (question b, clip j)."""
        enc = self.tokenizer(list(questions), max_length=self.max_txt_len)
        ids, mask = (torch.from_numpy(np.asarray(enc[k], np.int32)).to(self.device)
                     for k in ("input_ids", "attention_mask"))
        return ids.repeat_interleave(n, dim=0), mask.repeat_interleave(n, dim=0)

    def _ranked(self, pooled: np.ndarray, topk: int) -> List[List[Answer]]:
        probs = torch.softmax(torch.from_numpy(pooled).float(), dim=-1).numpy()
        out = []
        for row in probs:
            order = np.argsort(-row, kind="stable")[:topk]
            out.append([(self.label2ans.get(int(i), f"<label {int(i)}>"), float(row[i]))
                        for i in order])
        return out

    def predict(self, clips, question: str, topk: int = 5,
                pool: Optional[str] = None) -> List[Answer]:
        """clips: (n_clips, T, H, W, 3) uint8 — several sampled clips of one
        video are ensembled (reference multi-clip eval) — or the (n_clips,
        1+N, D) output of ``encode_video`` (cached fast path); returns the
        top-k (answer, probability) pairs."""
        clips = torch.as_tensor(clips)
        if clips.dim() not in (3, 5):
            raise ValueError(
                "clips must be (n_clips, T, H, W, 3) pixels or the (n_clips, 1+N, D) "
                f"output of encode_video, got {tuple(clips.shape)}"
            )
        n = clips.shape[0]
        ids, mask = self._tokens([question], n)
        batch = {"text_input_ids": ids, "text_input_mask": mask}
        batch["video_embeds" if clips.dim() == 3 else "visual_inputs"] = clips.to(self.device)
        logits = self._infer(batch).cpu().numpy()                  # (n_clips, L)
        return self._ranked(pool_clip_logits(logits[:, None, :], pool or self.pool), topk)[0]

    def predict_batch(self, clips, questions: Sequence[str], topk: int = 5,
                      pool: Optional[str] = None) -> List[List[Answer]]:
        """B questions about ONE video in one pass of text + fusion + head:
        the video tower runs at most once (pixels are encoded first; pass the
        output of ``encode_video`` to skip it). Per question the same pooling
        and ranking as ``predict``."""
        if not questions:
            return []
        clips = torch.as_tensor(clips)
        if clips.dim() == 5:
            clips = self.encode_video(clips)
        if clips.dim() != 3:
            raise ValueError(
                "clips must be (n_clips, T, H, W, 3) pixels or the (n_clips, 1+N, D) "
                f"output of encode_video, got {tuple(clips.shape)}"
            )
        n, B = clips.shape[0], len(questions)
        ids, mask = self._tokens(questions, n)
        batch = {"text_input_ids": ids, "text_input_mask": mask,
                 "video_embeds": clips.to(self.device).repeat(B, 1, 1)}
        logits = self._infer(batch).cpu().numpy()                  # (B·n, L)
        # (B·n, L) → (n_clips, B, L) for the reference multi-clip pooling
        pooled = pool_clip_logits(logits.reshape(B, n, -1).transpose(1, 0, 2),
                                  pool or self.pool)
        return self._ranked(pooled, topk)
