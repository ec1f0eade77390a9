"""A retrieval gallery sharded over processes (counterpart of
``alpro_tpu/serving/sharded.py``).

``RetrievalIndex`` holds two banks per gallery on its card: the 256-d VTC
features and the (1+N, D) token bank, ~300 KB a video in bf16, which caps
one card at a few hundred thousand videos. Here each process of a ``dp``
group holds its row slice of both banks, and a query runs the two-stage
distributed top-k:

1. every process scores the query against its slice of the feature bank
   and takes a local top-k, with its k candidate token rows;
2. one all-gather moves the (n_proc · k) survivors — scores, global ids,
   token rows — and never the bank;
3. a global top-k over the survivors feeds the VTM rerank, replicated on
   every process.

Every process calls ``add_videos`` with the same clips and ids; each embeds
only its slice of them (rows [r · m, (r + 1) · m) of a call of n clips,
m = ceil(n / W)), padded to m rows with copies of the call's last clip,
whose similarities are set to -inf. The kernels of the towers and the
rerank are those of ``RetrievalIndex``.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from alpro_tpu_torch.core.distributed import is_primary
from alpro_tpu_torch.core.trace import span
from alpro_tpu_torch.parallel.collectives import all_gather
from alpro_tpu_torch.parallel.host_sync import barrier
from alpro_tpu_torch.serving.retrieval import RetrievalIndex

# local rows a process sends the primary process at a time in ``save``
SAVE_BLOCK = 256


class ShardedRetrievalIndex(RetrievalIndex):
    """``RetrievalIndex`` with both gallery banks split over ``mesh[axis]``.

    >>> mesh = make_mesh()                    # dp over every process
    >>> idx = ShardedRetrievalIndex(model, tokenizer, "cuda", mesh)
    >>> idx.add_videos(clips, ids)            # on every process, same arguments
    >>> idx.query("a dog catches a frisbee")  # the same result on every process
    """

    def __init__(self, model, tokenizer, device, mesh, axis: str = "dp", **kw):
        super().__init__(model, tokenizer, device, **kw)
        ax = mesh[axis]
        self.group, self.n_proc, self.rank = ax.group, ax.size, ax.rank
        self._gidx_chunks = []  # (m,) int64 global row of each local row, -1 padding

    def add_videos(self, clips, ids: Sequence[str]) -> None:
        clips = torch.as_tensor(clips)
        if clips.dim() != 5 or clips.shape[0] != len(ids):
            raise ValueError(
                f"clips must be (B, T, H, W, 3) with B == len(ids); got "
                f"{tuple(clips.shape)} for {len(ids)} ids"
            )
        n = clips.shape[0]
        m = -(-n // self.n_proc)
        rows = np.arange(self.rank * m, (self.rank + 1) * m)
        gidx = np.where(rows < n, rows + len(self.ids), -1)
        with span("ingest"):
            with span("ingest.h2d"):
                pixels = clips[np.minimum(rows, n - 1)].to(self.device)
            embeds, feat = self._embed_video(pixels)
            self._token_chunks.append(embeds)
            self._feat_chunks.append(feat.float())
            self._gidx_chunks.append(torch.from_numpy(gidx).to(self.device))
            self.ids.extend(str(i) for i in ids)
            self._bank = None

    def _banks(self):
        if self._bank is None:
            self._bank = (torch.cat(self._feat_chunks), torch.cat(self._token_chunks),
                          torch.cat(self._gidx_chunks))
        return self._bank

    def _gathered(self, t: torch.Tensor) -> torch.Tensor:
        """(B, kk, ...) of every process → (B, n_proc · kk, ...), process-major."""
        g = all_gather(t.contiguous(), self.group)
        g = g.reshape((self.n_proc,) + tuple(t.shape)).transpose(0, 1)
        return g.reshape((t.shape[0], self.n_proc * t.shape[1]) + tuple(t.shape[2:]))

    @torch.inference_mode()
    def _score(self, texts: Sequence[str], topk):
        if not self.ids:
            raise ValueError("empty index: add_videos before querying")
        k = min(self.topk if topk is None else int(topk), len(self.ids))
        if k < 1:
            raise ValueError(f"topk must be >= 1 (got {topk!r})")
        with span("query"):
            feats, tokens, gidx = self._banks()
            with span("query.tokenize"):
                enc = self.tokenizer(list(texts), max_length=self.max_txt_len)
                ids = torch.from_numpy(np.asarray(enc["input_ids"], np.int32)).to(self.device)
                mask = torch.from_numpy(
                    np.asarray(enc["attention_mask"], np.int32)).to(self.device)
            text_embeds, tfeat = self._encode_text(
                {"text_input_ids": ids, "text_input_mask": mask})
            B = ids.shape[0]
            sims = torch.where(gidx[None, :] >= 0, tfeat @ feats.T, float("-inf"))
            local_s, local_i = torch.topk(sims, min(k, sims.shape[1]), dim=1)  # (B, kk)
            s_all = self._gathered(local_s)
            g_all = self._gathered(gidx[local_i])
            t_all = self._gathered(tokens[local_i])
            top_s, j = torch.topk(s_all, k, dim=1)  # the global top-k of the survivors
            cand = t_all[torch.arange(B, device=j.device)[:, None], j]  # (B, k, 1+N, D)
            logits = self._fusion_score(
                text_embeds.repeat_interleave(k, dim=0),  # query-major
                mask.repeat_interleave(k, dim=0),
                cand.reshape((B * k,) + tuple(cand.shape[2:])),
            )
            probs = torch.softmax(logits, dim=-1)[:, 1].reshape(B, k)
            with span("query.readback"):
                return (probs.cpu().numpy(), top_s.cpu().numpy(),
                        torch.gather(g_all, 1, j).cpu().numpy())

    def save(self, path: str) -> None:
        """The whole gallery in ``RetrievalIndex``'s format, written by the
        primary process: the processes of its group send it their rows in
        blocks of ``SAVE_BLOCK``, so that it alone holds the whole bank, on
        its host (a collective: every process calls it)."""
        if not self.ids:
            raise ValueError("cannot save an empty index: add videos first")
        feats, tokens, gidx = self._banks()
        # a group without the primary process holds a replica: nothing to send
        sends = (is_primary() if self.group is None
                 else 0 in dist.get_process_group_ranks(self.group))
        if sends:
            whole = None
            if is_primary():
                n = len(self.ids)
                whole = (np.empty((n,) + tuple(feats.shape[1:]), np.float32),
                         np.empty((n,) + tuple(tokens.shape[1:]), np.float32))
            for lo in range(0, gidx.shape[0], SAVE_BLOCK):
                hi = lo + SAVE_BLOCK
                blocks = self._gather_to_primary(
                    [gidx[lo:hi], feats[lo:hi].float(), tokens[lo:hi].float()])
                if whole is not None:
                    for g, f, t in zip(*blocks):
                        keep = (g >= 0).numpy()
                        rows = g.numpy()[keep]
                        whole[0][rows], whole[1][rows] = f.numpy()[keep], t.numpy()[keep]
            if whole is not None:
                npz, idsp = self._paths(path)
                os.makedirs(os.path.dirname(npz) or ".", exist_ok=True)
                np.savez(npz, feats=whole[0], tokens=whole[1])
                with open(idsp, "w") as f:
                    json.dump(self.ids, f)
        barrier("index-save")

    def _gather_to_primary(self, parts):
        """Each tensor of ``parts`` from every process of the group, on the
        primary process's host in group order (a list per part); None on
        the others. NCCL moves CUDA tensors, gloo host ones."""
        if self.group is None:
            return [[p.cpu()] for p in parts]
        device = self.device if dist.get_backend(self.group) == "nccl" else torch.device("cpu")
        out = []
        for p in parts:
            p = p.contiguous().to(device)
            into = [torch.empty_like(p) for _ in range(self.n_proc)] if is_primary() else None
            dist.gather(p, into, dst=0, group=self.group)
            out.append(None if into is None else [t.cpu() for t in into])
        return out if is_primary() else None

    def load(self, path: str) -> None:
        """Reads a bank saved by either package. Each process reads only its
        slice of the rows from the memory-mapped file and moves that slice
        to its device, the tokens in the dtype its model embeds videos in."""
        npz, idsp = self._paths(path)
        with open(idsp) as f:
            ids = [str(i) for i in json.load(f)]
        n = len(ids)
        m = -(-n // self.n_proc)
        rows = np.arange(self.rank * m, (self.rank + 1) * m)
        take = np.minimum(rows, n - 1)
        feats, tokens = (np.ascontiguousarray(_npz_member(npz, k)[take])
                         for k in ("feats", "tokens"))
        if tokens.dtype.kind == "V" and tokens.dtype.itemsize == 2:  # bf16 bits from JAX
            tok = torch.from_numpy(tokens.view(np.int16)).view(torch.bfloat16)
        else:
            tok = torch.from_numpy(tokens)
        self._feat_chunks = [torch.from_numpy(feats).float().to(self.device)]
        self._token_chunks = [tok.to(self.device, self.model.visual_encoder.model.dtype)]
        self._gidx_chunks = [torch.from_numpy(np.where(rows < n, rows, -1)).to(self.device)]
        self.ids = ids
        self._bank = None


def _npz_member(npz: str, name: str) -> np.ndarray:
    """The array ``name`` of an ``np.savez`` file, memory-mapped: only the
    rows taken from it are read. A compressed member is read whole."""
    with zipfile.ZipFile(npz) as z:
        info = z.getinfo(name + ".npy")
        if info.compress_type != zipfile.ZIP_STORED:
            with z.open(info) as f:
                return np.lib.format.read_array(f)
    with open(npz, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)  # the zip local file header, then its name and extra field
        f.seek(info.header_offset + 30 + int.from_bytes(local[26:28], "little")
               + int.from_bytes(local[28:30], "little"))
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        offset = f.tell()
    return np.memmap(npz, dtype=dtype, mode="r", shape=shape, offset=offset,
                     order="F" if fortran else "C")
