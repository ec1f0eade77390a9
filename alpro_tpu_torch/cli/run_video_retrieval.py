"""Text↔video retrieval: finetuning, and the eval protocol behind R@1/5/10.

The port's counterpart of ``alpro_tpu/cli/run_video_retrieval.py``:

    python -m alpro_tpu_torch.cli.run_video_retrieval --config configs/msrvtt_ret.json \
        --output_dir out/ [--device cpu]
    python -m alpro_tpu_torch.cli.run_video_retrieval --config configs/msrvtt_ret.json \
        --output_dir out/ --do_inference 1 [--inference_model_step N | \
        --inference_model_ckpt model.pt] [--device cpu]

Finetuning (``--do_inference 0``) trains VTC + VTM on the first training
dataset's (clip, caption) pairs from ``e2e_weights_path``, validates with
the eval protocol and writes a deploy checkpoint ``ckpt/model_step_N.pt``
every validation interval, resume checkpoints in ``restore/``, and a last
validation and deploy checkpoint at the end (``cli/common.py``).

Every text is scored against every video. The text tower runs once per text
and each video's tower once; only the fusion half runs per (video, text)
pair, ``eval_video_batch_size`` videos × ``inference_batch_size`` texts in
one call. The ranking score is the ITM head's P(match), the VTC similarity
carried alongside; ``eval_vtc_only`` ranks by the similarity alone and
``eval_rerank_topk`` K > 0 reranks only each text's K best VTC candidates.
The similarities, the candidate choice and the score bands are computed on
the host in numpy, where the JAX CLI computes them, so both packages pick
the same candidates from the same similarities. Across processes the
videos are striped by rank and the results merged by ``all_gather_list``,
as in the JAX CLI; rank 0 writes ``results.json``.
"""

from __future__ import annotations

import json
import os
import time
from typing import List

import numpy as np
import torch

from alpro_tpu_torch.cli import common
from alpro_tpu_torch.core.config import Config, get_video_retrieval_args
from alpro_tpu_torch.core.distributed import (data_shards, is_primary, local_batch_size,
                                              reads_rows)
from alpro_tpu_torch.core.logging import LOGGER, TB_LOGGER
from alpro_tpu_torch.data.datasets import (
    RetrievalCollator,
    RetrievalDataset,
    RetrievalEvalDataset,
    load_datalist,
)
from alpro_tpu_torch.data.loader import BatchLoader, InfiniteIterator
from alpro_tpu_torch.data.tokenization import build_tokenizer
from alpro_tpu_torch.evals.retrieval import eval_retrieval
from alpro_tpu_torch.parallel.host_sync import all_gather_list
from alpro_tpu_torch.serving.inference import (
    make_fusion_rerank_bank_fn,
    make_fusion_score_pairs_fn,
    make_text_encode_fn,
    make_video_embed_fn,
)
from alpro_tpu_torch.train.step import make_retrieval_train_step


def _mk_datasets(cfg: Config, tokenizer):
    """(the shuffled training ``BatchLoader`` over this process's stripe of
    the first training dataset — its first ``data_ratio`` share of rows,
    this process's rows of ``train_batch_size`` pairs a batch, ``n_workers``
    threads —, the first val dataset's ``RetrievalEvalDataset``)."""
    train_rows = load_datalist(cfg.train_datasets[0]["txt"])
    if cfg.get("data_ratio", 1.0) < 1.0:
        train_rows = train_rows[: max(1, int(len(train_rows) * cfg.data_ratio))]
    train_ds = RetrievalDataset(
        train_rows, cfg.train_datasets[0]["img"], num_frm=cfg.num_frm,
        frm_sampling_strategy=cfg.get("frm_sampling_strategy", "rand"),
        resize_size=cfg.resize_size, crop_size=cfg.crop_img_size,
        seed=cfg.get("seed", 42), fps=cfg.get("fps", -1),
    )
    num_shards, shard_id = data_shards(cfg.get("mesh_shape"))
    train_loader = BatchLoader(
        train_ds, RetrievalCollator(tokenizer, cfg.max_txt_len),
        local_batch_size(cfg.train_batch_size, cfg.get("mesh_shape")), shuffle=True,
        seed=cfg.get("seed", 42),
        num_shards=num_shards, shard_id=shard_id, num_workers=int(cfg.get("n_workers", 4)),
        placeholder=not reads_rows(cfg.get("mesh_shape")),
    )
    eval_ds = RetrievalEvalDataset(
        load_datalist(cfg.val_datasets[0]["txt"]), cfg.val_datasets[0]["img"],
        num_frm=cfg.num_frm, resize_size=cfg.resize_size, crop_size=cfg.crop_img_size,
        fps=cfg.get("fps", -1),
    )
    return train_loader, eval_ds


def _encode_texts(model, eval_ds, tokenizer, cfg: Config, device):
    """Tokenize every text, pad to a multiple of ``inference_batch_size``
    with all-zero ids and masks, and run the text half once per chunk:
    (text_embeds chunks, the (n_text, L) mask on the device, the
    (n_text, 256) VTC features on the host, n_text)."""
    eval_bsz = int(cfg.get("inference_batch_size", 64))
    encode_text = make_text_encode_fn(model)
    enc = tokenizer([t["caption"] for t in eval_ds.texts], max_length=cfg.max_txt_len)
    all_ids = np.asarray(enc["input_ids"], np.int32)
    all_mask = np.asarray(enc["attention_mask"], np.int32)
    n_text = len(eval_ds.texts)
    pad = (-n_text) % eval_bsz
    ids_p = np.concatenate([all_ids, np.zeros((pad, all_ids.shape[1]), np.int32)])
    mask_p = np.concatenate([all_mask, np.zeros((pad, all_mask.shape[1]), np.int32)])
    ids_d, mask_d = torch.from_numpy(ids_p).to(device), torch.from_numpy(mask_p).to(device)
    embeds, feats = [], []
    for start in range(0, ids_p.shape[0], eval_bsz):
        te, tf = encode_text({"text_input_ids": ids_d[start:start + eval_bsz],
                              "text_input_mask": mask_d[start:start + eval_bsz]})
        embeds.append(te)
        feats.append(tf.cpu().numpy())
    return embeds, mask_d, np.concatenate(feats)[:n_text], n_text


def _temperature(model) -> float:
    return float(np.clip(model.temp.detach().float().cpu().numpy(), 0.001, 0.5))


def _video_batches(eval_ds, cfg: Config):
    """(videos, clips padded to ``eval_video_batch_size`` by repeating the
    last) per batch of the videos this process scores: its stripe (every
    ``num_shards``-th from ``shard_id``) of all of them, or of 5 under
    ``debug``."""
    vid_bsz = int(cfg.get("eval_video_batch_size", 8))
    n_videos = len(eval_ds) if not cfg.get("debug") else min(5, len(eval_ds))
    num_shards, shard_id = data_shards()
    mine = list(range(shard_id, n_videos, num_shards))
    for vstart in range(0, len(mine), vid_bsz):
        videos = [eval_ds.get_video(vi) for vi in mine[vstart:vstart + vid_bsz]]
        clips = np.stack([v["clip"] for v in videos])
        if clips.shape[0] < vid_bsz:  # one shape for every call
            clips = np.concatenate([clips, np.repeat(clips[-1:], vid_bsz - clips.shape[0], 0)])
        yield videos, clips


def _merged(results: List[dict]) -> List[dict]:
    """Every process's results, in rank order."""
    return [r for shard in all_gather_list(results) for r in shard]


def inference_retrieval(model, eval_ds, tokenizer, cfg: Config) -> List[dict]:
    """The retrieval eval protocol → [{vid_id, txt_id, score, sim}] for every
    (video, text) pair: ``score`` is P(match) (K = 0), the VTC similarity
    (``eval_vtc_only``) or the top-K band score (``eval_rerank_topk``, over
    each process's own videos, as the JAX CLI ranks them). Every process
    gets every process's results."""
    rerank_topk = int(cfg.get("eval_rerank_topk", 0))
    if rerank_topk > 0 and not cfg.get("eval_vtc_only", False):
        return _merged(_inference_retrieval_topk(model, eval_ds, tokenizer, cfg, rerank_topk))
    device = common.model_device(model)
    eval_bsz = int(cfg.get("inference_batch_size", 64))
    embed_video = make_video_embed_fn(model)
    fusion_score = make_fusion_score_pairs_fn(model)
    text_embeds_chunks, mask_d, text_feat_all, n_text = _encode_texts(
        model, eval_ds, tokenizer, cfg, device)
    temp = _temperature(model)
    texts = eval_ds.texts
    vtc_only = bool(cfg.get("eval_vtc_only", False))

    results = []
    st = time.time()
    scored = 0
    for videos, clips in _video_batches(eval_ds, cfg):
        video_embeds, vfeat = embed_video(torch.from_numpy(clips).to(device))
        sims_block = vfeat.cpu().numpy() @ text_feat_all.T / temp  # (vb, n_text)
        if not vtc_only:
            # one call scores all the batch's videos against a text chunk
            probs_block = np.empty((len(videos), n_text), np.float32)
            for ci, start in enumerate(range(0, mask_d.shape[0], eval_bsz)):
                logits = fusion_score(text_embeds_chunks[ci], mask_d[start:start + eval_bsz],
                                      video_embeds)  # (vid_bsz, eval_bsz, 2)
                probs = torch.softmax(logits, dim=-1)[..., 1].cpu().numpy()
                end = min(start + eval_bsz, n_text)
                probs_block[:, start:end] = probs[: len(videos), : end - start]
        for bi, video in enumerate(videos):
            sims = sims_block[bi]
            row = sims if vtc_only else probs_block[bi]
            for j in range(n_text):
                results.append(dict(vid_id=video["vid_id"], txt_id=texts[j]["txt_id"],
                                    score=float(row[j]), sim=float(sims[j])))
        scored += len(videos)
        if (scored % 50) < len(videos):
            LOGGER.info("scored %d videos (%.1fs)", scored, time.time() - st)
    return _merged(results)


def _inference_retrieval_topk(model, eval_ds, tokenizer, cfg: Config, K: int) -> List[dict]:
    """``eval_rerank_topk K``: the towers run as in the full protocol, then
    each text's K best VTC candidates are reranked by the fusion half, in
    calls of ``eval_pair_batch_size`` pairs gathered on the device from the
    video token bank. Candidates score 1 + P(match) ∈ (1, 2), the rest
    0.5 + atan(sim)/π ∈ (0, 1), so text→video ranks are exact for the
    candidates; with 0 < K < V the transposed video→text ranks are an
    approximation (only texts that shortlisted a video rank it by P(match)).
    K ≥ V ranks as the full protocol."""
    device = common.model_device(model)
    eval_bsz = int(cfg.get("inference_batch_size", 64))
    pair_bsz = int(cfg.get("eval_pair_batch_size", 512))
    embed_video = make_video_embed_fn(model)
    rerank_bank = make_fusion_rerank_bank_fn(model)
    text_embeds_chunks, mask_d, text_feat_all, n_text = _encode_texts(
        model, eval_ds, tokenizer, cfg, device)
    temp = _temperature(model)
    texts = eval_ds.texts

    st = time.time()
    # 1) video towers once; the token embeds stay on the device as the bank
    embed_blocks, vfeat_rows, vid_ids = [], [], []
    for videos, clips in _video_batches(eval_ds, cfg):
        video_embeds, vfeat = embed_video(torch.from_numpy(clips).to(device))
        embed_blocks.append(video_embeds[: len(videos)])
        vfeat_rows.append(vfeat.cpu().numpy()[: len(videos)])
        vid_ids.extend(v["vid_id"] for v in videos)
    n_local = len(vid_ids)
    if n_local == 0:  # no video to score here (an empty set, or stripe)
        return []
    bank = torch.cat(embed_blocks)  # (V, 1+N, D) on the device
    sims = np.concatenate(vfeat_rows) @ text_feat_all.T / temp  # (V, n_text)
    k = min(K, n_local)

    # 2) per text: the VTC top-k candidates → batched pair rerank;
    # cand_idx[j] = the k video rows text j reranks
    cand_idx = np.argpartition(-sims, k - 1, axis=0)[:k].T  # (n_text, k)
    probs = np.zeros((n_text, k), np.float32)
    for ci, start in enumerate(range(0, mask_d.shape[0], eval_bsz)):
        end = min(start + eval_bsz, n_text)
        if end <= start:
            break
        ntc = end - start
        tidx = np.repeat(np.arange(ntc, dtype=np.int64), k)
        vidx = cand_idx[start:end].reshape(-1).astype(np.int64)
        npairs = tidx.shape[0]
        ppad = (-npairs) % pair_bsz
        tidx = torch.from_numpy(np.concatenate([tidx, np.zeros(ppad, np.int64)])).to(device)
        vidx = torch.from_numpy(np.concatenate([vidx, np.zeros(ppad, np.int64)])).to(device)
        chunk_probs = np.empty(npairs + ppad, np.float32)
        for ps in range(0, npairs + ppad, pair_bsz):
            logits = rerank_bank(text_embeds_chunks[ci], mask_d[start:start + eval_bsz], bank,
                                 tidx[ps:ps + pair_bsz], vidx[ps:ps + pair_bsz])
            chunk_probs[ps:ps + pair_bsz] = torch.softmax(logits, dim=-1)[:, 1].cpu().numpy()
        probs[start:end] = chunk_probs[:npairs].reshape(ntc, k)
        if (end % (eval_bsz * 4)) < eval_bsz:
            LOGGER.info("reranked %d/%d texts (%.1fs)", end, n_text, time.time() - st)

    # 3) combined scores: candidates 1 + P(match), the rest VTC-ordered < 1
    scores = 0.5 + np.arctan(sims) / np.pi
    scores[cand_idx.T, np.arange(n_text)[None, :]] = 1.0 + probs.T
    return [dict(vid_id=vid_ids[bi], txt_id=texts[j]["txt_id"],
                 score=float(scores[bi, j]), sim=float(sims[bi, j]))
            for bi in range(n_local) for j in range(n_text)]


def validate(model, eval_ds, tokenizer, cfg: Config, step) -> dict:
    """The eval protocol on ``eval_ds`` with the model as it stands at
    ``step``: R@k logged and written to ``TB_LOGGER`` as ``val_t2v_*``
    (``debug`` scores 5 videos, and the metrics cover their texts). A
    protocol that cannot be scored is logged and gives {}."""
    results = inference_retrieval(model, eval_ds, tokenizer, cfg)
    if cfg.get("debug"):
        vids_scored = {r["vid_id"] for r in results}
        keep_txt = {r["txt_id"] for r in results}
        gt = {t: v for t, v in eval_ds.gt_txt_id2vid_id.items()
              if t in keep_txt and v in vids_scored}
        results = [r for r in results if r["txt_id"] in gt]
    else:
        gt = eval_ds.gt_txt_id2vid_id
    try:
        metrics = eval_retrieval(results, gt)
    except (AssertionError, IndexError) as e:
        LOGGER.warning("retrieval eval skipped: %s", e)
        return {}
    LOGGER.info("step %s retrieval: %s", step, json.dumps(metrics))
    TB_LOGGER.log_scalar_dict({f"t2v_{k}": v for k, v in metrics["text2video"].items()},
                              prefix="val")
    return metrics


def start_training(cfg: Config):
    """Finetune the retrieval model (``cli/common.py``'s setup and loop,
    ``vtm_negative_blocks`` blocks of hard negatives), validate once more at
    the end and write the last deploy checkpoint. Returns the train state."""
    common.setup_environment(cfg)
    tokenizer = build_tokenizer(cfg.tokenizer_dir)
    model = common.build_model_from_cfg(cfg, "retrieval", seed=cfg.get("seed", 42))
    train_loader, eval_ds = _mk_datasets(cfg, tokenizer)
    step_fn, state, num_steps, restorer = common.setup_training(
        cfg, model,
        lambda m, opt: make_retrieval_train_step(
            m, opt, num_local_blocks=cfg.get("vtm_negative_blocks", 1)),
        steps_per_epoch=len(train_loader),
    )
    LOGGER.info("training retrieval for %d steps on %s", num_steps, common.model_device(model))
    state = common.run_train_loop(
        cfg, step_fn, state, InfiniteIterator(train_loader), num_steps, restorer=restorer,
        validate_fn=lambda s, gs: validate(model, eval_ds, tokenizer, cfg, gs),
        save_model_fn=common.default_save_model_fn(cfg, model),
    )
    validate(model, eval_ds, tokenizer, cfg, "final")
    common.default_save_model_fn(cfg, model)(state, state.step)
    return state


def start_inference(cfg: Config) -> dict:
    """Build the model, load the inference weights, run the protocol over
    ``inference_txt_db``/``inference_img_db`` (default the first val
    dataset), and write ``output_dir/results.json`` ({metrics, results}).
    Returns the metrics."""
    common.setup_environment(cfg)
    # a training run's stored args override all but the inference keys and
    # the eval-protocol knobs, which stay this run's choice
    common.merge_stored_args(cfg, keep=("output_dir", "eval_rerank_topk", "eval_vtc_only",
                                        "device"))
    tokenizer = build_tokenizer(cfg.tokenizer_dir)
    model = common.build_model_from_cfg(cfg, "retrieval")
    common.load_inference_params(model, cfg)

    txt = cfg.get("inference_txt_db") or cfg.val_datasets[0]["txt"]
    img = cfg.get("inference_img_db") or cfg.val_datasets[0]["img"]
    eval_ds = RetrievalEvalDataset(
        load_datalist(txt), img, num_frm=cfg.num_frm,
        resize_size=cfg.resize_size, crop_size=cfg.crop_img_size,
        fps=cfg.get("fps", -1),
    )
    results = inference_retrieval(model, eval_ds, tokenizer, cfg)
    gt = eval_ds.gt_txt_id2vid_id
    if cfg.get("debug"):
        # debug scores 5 videos: the protocol runs on the scored subset
        vids_scored = {r["vid_id"] for r in results}
        gt = {t: v for t, v in gt.items() if v in vids_scored}
        results = [r for r in results if r["txt_id"] in gt]
    metrics = eval_retrieval(results, gt)
    LOGGER.info("inference retrieval: %s", json.dumps(metrics))
    if cfg.get("output_dir") and is_primary():
        out = os.path.join(cfg.output_dir, "results.json")
        with open(out, "w") as f:
            json.dump({"metrics": metrics, "results": results}, f)
        LOGGER.info("wrote %s", out)
    return metrics


def main(argv=None):
    cfg = get_video_retrieval_args(argv)
    if cfg.get("do_inference"):
        return start_inference(cfg)
    return start_training(cfg)


if __name__ == "__main__":
    main()
