"""Text→video retrieval serving: an indexed video gallery and the query path.

Counterpart of ``alpro_tpu/serving/retrieval.py::RetrievalIndex``. Videos are
embedded once into two banks on the device — the L2-normalized 256-d VTC
features (candidate generation) and the (1+N, D) token banks (reranking) —
and each query costs: tokenize + text half + projection; VTC similarity
against the feature bank → top-k candidates; the fusion half over
[text; candidate tokens] and ``itm_head``, ranked by P(match) with the VTC
similarity carried alongside.

``query`` and ``query_batch`` share one scoring core, and an empty index
raises ``ValueError`` before topk is clamped. Banks persist as ``<path>.npz``
(``feats``, ``tokens``) plus ``<path>.ids.json``, the JAX package's format,
so either package loads a bank the other saved.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from alpro_tpu_torch.core.trace import span
from alpro_tpu_torch.ops.quant import quantize_tree
from alpro_tpu_torch.serving.inference import (
    make_fusion_score_fn,
    make_text_encode_fn,
    make_video_embed_fn,
)

Result = Tuple[str, float, float]  # (video id, P(match), VTC similarity)


class RetrievalIndex:
    """Video gallery index + query path for one retrieval model.

    >>> idx = RetrievalIndex(model, tokenizer, "cuda")
    >>> idx.add_videos(clips_uint8, ids=["v1", "v2"])   # (B, T, H, W, 3)
    >>> idx.query("a dog catches a frisbee", topk=5)
    [("v2", 0.93, 0.41), ...]
    """

    def __init__(self, model, tokenizer, device, max_txt_len: int = 40,
                 topk: int = 16, weights: str = "bf16"):
        """``model`` must already live on ``device``. ``weights``: 'bf16'
        serves the model's weights as they are; 'int8' serves a copy with
        per-channel int8 weight storage, dequantized as each call reads them
        (``ops/quant.py::quantize_tree``; ``model`` itself is unchanged)."""
        if weights not in ("bf16", "int8"):
            raise ValueError(f"weights must be 'bf16' or 'int8', got {weights!r}")
        if weights == "int8":
            model = quantize_tree(model)
        self.model = model
        self.tokenizer = tokenizer
        self.device = torch.device(device)
        self.max_txt_len = int(max_txt_len)
        self.topk = int(topk)
        self.weights = weights
        self._embed_video = make_video_embed_fn(model)
        self._encode_text = make_text_encode_fn(model)
        self._fusion_score = make_fusion_score_fn(model)
        self.ids: List[str] = []
        self._feat_chunks: List[torch.Tensor] = []   # (b, 256) fp32, normalized
        self._token_chunks: List[torch.Tensor] = []  # (b, 1+N, D)
        self._bank = None  # (feats, tokens) concatenated on the device

    # -- gallery -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.ids)

    def add_videos(self, clips, ids: Sequence[str]) -> None:
        """clips: (B, T, H, W, 3) uint8, numpy or tensor (already sampled and
        cropped to the model's frames and size); ids: B identifiers."""
        clips = torch.as_tensor(clips)
        if clips.dim() != 5 or clips.shape[0] != len(ids):
            raise ValueError(
                f"clips must be (B, T, H, W, 3) with B == len(ids); got "
                f"{tuple(clips.shape)} for {len(ids)} ids"
            )
        with span("ingest"):
            with span("ingest.h2d"):
                pixels = clips.to(self.device)
            embeds, feat = self._embed_video(pixels)
            self._token_chunks.append(embeds)
            self._feat_chunks.append(feat.float())
            self.ids.extend(str(i) for i in ids)
            self._bank = None

    def _banks(self):
        if self._bank is None:
            self._bank = (torch.cat(self._feat_chunks), torch.cat(self._token_chunks))
        return self._bank

    # -- query -------------------------------------------------------------
    @torch.inference_mode()
    def _score(self, texts: Sequence[str], topk: Optional[int]):
        """The scoring core: B texts → (P(match), VTC sims, bank rows), each
        (B, k) on the host, in VTC top-k order."""
        if not self.ids:
            raise ValueError("empty index: add_videos before querying")
        k = min(self.topk if topk is None else int(topk), len(self.ids))
        if k < 1:
            raise ValueError(f"topk must be >= 1 (got {topk!r})")
        with span("query"):
            feats, tokens = self._banks()
            with span("query.tokenize"):
                enc = self.tokenizer(list(texts), max_length=self.max_txt_len)
                ids = torch.from_numpy(np.asarray(enc["input_ids"], np.int32)).to(self.device)
                mask = torch.from_numpy(
                    np.asarray(enc["attention_mask"], np.int32)).to(self.device)
            text_embeds, tfeat = self._encode_text(
                {"text_input_ids": ids, "text_input_mask": mask}
            )
            B = ids.shape[0]
            top_sims, top_idx = torch.topk(tfeat @ feats.T, k, dim=1)   # (B, k)
            logits = self._fusion_score(
                text_embeds.repeat_interleave(k, dim=0),                 # query-major
                mask.repeat_interleave(k, dim=0),
                tokens[top_idx.reshape(-1)],
            )
            probs = torch.softmax(logits, dim=-1)[:, 1].reshape(B, k)
            with span("query.readback"):
                return probs.cpu().numpy(), top_sims.cpu().numpy(), top_idx.cpu().numpy()

    def _ranked(self, probs, sims, idx) -> List[Result]:
        order = np.argsort(-probs, kind="stable")
        return [(self.ids[int(idx[j])], float(probs[j]), float(sims[j])) for j in order]

    def query(self, text: str, topk: Optional[int] = None) -> List[Result]:
        """[(vid_id, P(match), vtc_sim)] ranked by P(match) over the VTC
        top-k candidates."""
        probs, sims, idx = self._score([text], topk)
        return self._ranked(probs[0], sims[0], idx[0])

    def query_batch(self, texts: Sequence[str],
                    topk: Optional[int] = None) -> List[List[Result]]:
        """B queries through one batched pass of each tower; per text the
        same ranking protocol as ``query``."""
        if not self.ids:
            raise ValueError("empty index: add_videos before querying")
        if not texts:
            return []
        probs, sims, idx = self._score(texts, topk)
        return [self._ranked(p, s, i) for p, s, i in zip(probs, sims, idx)]

    # -- persistence -------------------------------------------------------
    @staticmethod
    def _paths(path: str) -> Tuple[str, str]:
        base = path[:-4] if path.endswith(".npz") else path
        return base + ".npz", base + ".ids.json"

    def save(self, path: str) -> None:
        """Writes the banks and ids (not the weights). Tokens are written as
        fp32 (numpy has no bf16), which both packages read."""
        if not self.ids:
            raise ValueError("cannot save an empty index: add videos first")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        npz, idsp = self._paths(path)
        feats, tokens = self._banks()
        np.savez(npz, feats=feats.float().cpu().numpy(),
                 tokens=tokens.float().cpu().numpy())
        with open(idsp, "w") as f:
            json.dump(self.ids, f)

    def load(self, path: str) -> None:
        """Reads a bank saved by either package. A bf16 token bank saved by
        the JAX package arrives as 2-byte void records holding bf16 bits."""
        npz, idsp = self._paths(path)
        with np.load(npz) as data:
            feats, tokens = data["feats"], data["tokens"]
        if tokens.dtype.kind == "V" and tokens.dtype.itemsize == 2:
            tok = torch.from_numpy(tokens.view(np.int16)).view(torch.bfloat16)
        else:
            tok = torch.from_numpy(tokens)
        with open(idsp) as f:
            ids = [str(i) for i in json.load(f)]
        self._feat_chunks = [torch.from_numpy(feats).float().to(self.device)]
        self._token_chunks = [tok.to(self.device)]
        self.ids = ids
        self._bank = None
