"""Video QA: finetuning, and the eval protocol behind MSRVTT-QA / MSVD-QA accuracy.

The port's counterpart of ``alpro_tpu/cli/run_video_qa.py``:

    python -m alpro_tpu_torch.cli.run_video_qa --config configs/msrvtt_qa.json \
        --output_dir out/ [--device cpu]
    python -m alpro_tpu_torch.cli.run_video_qa --config configs/msrvtt_qa.json \
        --output_dir out/ --do_inference 1 [--inference_model_step N | \
        --inference_model_ckpt model.pt] [--device cpu]

Finetuning (``--do_inference 0``) trains the answer classifier's cross
entropy on the first training dataset from ``e2e_weights_path`` (each
question's ``train_n_clips`` clips forwarded in turn, only the last one's
loss backpropagated, as in the reference), validating and writing a deploy
checkpoint every validation interval and resume checkpoints in
``restore/`` (``cli/common.py``), and validates once more at the end.

Each question's video is sampled as ``inference_n_clips`` clips of
``num_frm`` frames (one ``num_frm · n_clips`` frame stack); the per-clip
logits are pooled by ``score_agg_func`` (mean, max or lse) and the answer is
their argmax. Open-ended tasks classify over ``num_labels`` answers;
multi-choice tasks (``action``, ``transition``) score each option as
question + option and pick the best of ``n_options``. Accuracy, overall and
per answer type, comes from ``evals/qa.py::evaluate_qa``. Across processes
each loads its stripe of the questions and the results are merged by
``all_gather_list``, as in the JAX CLI; rank 0 writes ``qa_results.json``.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np
import torch

from alpro_tpu_torch.cli import common
from alpro_tpu_torch.core.config import Config, get_video_qa_args
from alpro_tpu_torch.core.distributed import (data_shards, is_primary, local_batch_size,
                                              reads_rows)
from alpro_tpu_torch.core.logging import LOGGER, TB_LOGGER
from alpro_tpu_torch.data.datasets import (
    MULTI_CHOICE_QA,
    QACollator,
    VideoQADataset,
    load_datalist,
    load_json,
)
from alpro_tpu_torch.data.loader import BatchLoader, InfiniteIterator
from alpro_tpu_torch.data.tokenization import build_tokenizer
from alpro_tpu_torch.evals.qa import pool_clip_logits
from alpro_tpu_torch.parallel.host_sync import all_gather_list
from alpro_tpu_torch.serving.inference import make_qa_inference_fn
from alpro_tpu_torch.train.step import make_qa_train_step


def _is_multi_choice(cfg: Config) -> bool:
    return cfg.get("task", "msrvtt_qa") in MULTI_CHOICE_QA


def _effective_n_options(cfg: Config) -> int:
    """1 for open-ended; n_options for action/transition. Multi-choice uses a
    single-logit classifier regrouped to (B, n_options): ``num_labels`` is
    forced to 1 (the TGIF-QA protocol)."""
    if not _is_multi_choice(cfg):
        return 1
    if int(cfg.get("num_labels", 1)) != 1:
        LOGGER.info("multi-choice task %s: forcing num_labels=1 "
                    "(per-option scalar logits)", cfg.get("task"))
        cfg["num_labels"] = 1
    return int(cfg.get("n_options", 5))


def _qa_collator(cfg: Config, tokenizer) -> QACollator:
    return QACollator(
        tokenizer, cfg.max_txt_len,
        task_type=cfg.get("task", "msrvtt_qa"),
        n_options=int(cfg.get("n_options", 5)),
    )


def _mk_datasets(cfg: Config, split: str = "val") -> VideoQADataset:
    """``split='train'``: the first training dataset (its first
    ``data_ratio`` share of rows), ``train_n_clips`` · ``num_frm`` frames
    sampled by ``frm_sampling_strategy`` with random crops, with labels.
    Else the eval split: ``inference_txt_db``/``inference_img_db`` under
    ``do_inference`` when given, else the first val dataset, sampled
    uniformly and center-cropped; its labels are not read (accuracy
    compares answer strings), so out-of-vocabulary answers never fail a
    lookup."""
    if split == "train":
        spec = cfg.train_datasets[0]
    elif cfg.get("do_inference") and cfg.get("inference_txt_db"):
        spec = {
            "txt": cfg.inference_txt_db,
            "img": cfg.get("inference_img_db")
            or (cfg.val_datasets[0]["img"] if cfg.get("val_datasets") else None),
        }
    else:
        spec = cfg.val_datasets[0]
    txt = spec["txt"]
    if isinstance(txt, dict):
        txt = list(txt.values())[0]
    rows = load_datalist(txt)
    train = split == "train"
    if train and cfg.get("data_ratio", 1.0) < 1.0:
        rows = rows[: max(1, int(len(rows) * cfg.data_ratio))]
    # multi-choice tasks carry their answers as option indices — no vocab
    ans2label = {} if _is_multi_choice(cfg) else load_json(cfg.ans2label_path)
    n_clips = cfg.get("train_n_clips", 1) if train else cfg.get("inference_n_clips", 1)
    return VideoQADataset(
        rows, spec["img"], ans2label,
        num_frm=cfg.num_frm * n_clips,
        frm_sampling_strategy=cfg.get("frm_sampling_strategy", "rand") if train else "uniform",
        resize_size=cfg.resize_size, crop_size=cfg.crop_img_size,
        is_train=train, seed=cfg.get("seed", 42),
        return_label=train, task_type=cfg.get("task", "msrvtt_qa"),
        fps=cfg.get("fps", -1),
    )


def inference_qa(model, ds, tokenizer, cfg: Config) -> List[dict]:
    """Multi-clip eval → [{question_id, answer (label or option index)}]:
    the (B, n_clips · num_frm) frame stack as (B, n_clips, num_frm), one
    forward per clip, the clips' logits pooled."""
    infer = make_qa_inference_fn(model, n_options=_effective_n_options(cfg))
    device = common.model_device(model)
    num_shards, shard_id = data_shards()
    loader = BatchLoader(
        ds, _qa_collator(cfg, tokenizer), cfg.get("inference_batch_size", cfg.val_batch_size),
        shuffle=False, drop_last=False, num_shards=num_shards, shard_id=shard_id,
        num_workers=int(cfg.get("n_workers", 4)),
    )
    num_clips = int(cfg.get("inference_n_clips", 1))
    num_frm = cfg.num_frm
    results = []
    for batch in loader:
        vis = batch["visual_inputs"]
        B = vis.shape[0]
        vis = torch.from_numpy(vis.reshape(B, num_clips, num_frm, *vis.shape[2:])).to(device)
        ids = torch.from_numpy(batch["text_input_ids"]).to(device)
        mask = torch.from_numpy(batch["text_input_mask"]).to(device)
        clip_logits = [
            infer({"visual_inputs": vis[:, c], "text_input_ids": ids,
                   "text_input_mask": mask}).cpu().numpy()
            for c in range(num_clips)
        ]
        logits = pool_clip_logits(np.stack(clip_logits), cfg.get("score_agg_func", "mean"))
        for qid, p in zip(batch["question_ids"], logits.argmax(-1)):
            results.append({"question_id": qid, "answer": int(p)})
        if cfg.get("debug") and len(results) >= 2 * B:
            break
    return [r for shard in all_gather_list(results) for r in shard]


def validate(model, ds, tokenizer, cfg: Config, step) -> dict:
    """The eval protocol on ``ds`` with the model as it stands at ``step``:
    accuracy logged and written to ``TB_LOGGER`` as ``val_*``."""
    metrics = ds.evaluate_qa(inference_qa(model, ds, tokenizer, cfg))
    LOGGER.info("step %s qa: %s", step, json.dumps(metrics))
    TB_LOGGER.log_scalar_dict({k: v for k, v in metrics.items() if isinstance(v, float)},
                              prefix="val")
    return metrics


def start_training(cfg: Config):
    """Finetune the QA model (``cli/common.py``'s setup and loop; a
    multi-choice task forces ``num_labels`` 1 and trains over ``n_options``
    rows a question) and validate once more at the end. Returns the train
    state."""
    common.setup_environment(cfg)
    tokenizer = build_tokenizer(cfg.tokenizer_dir)
    n_options = _effective_n_options(cfg)  # may force num_labels=1 (multi-choice)
    model = common.build_model_from_cfg(cfg, "qa", seed=cfg.get("seed", 42))
    num_shards, shard_id = data_shards(cfg.get("mesh_shape"))
    train_loader = BatchLoader(
        _mk_datasets(cfg, "train"), _qa_collator(cfg, tokenizer),
        local_batch_size(cfg.train_batch_size, cfg.get("mesh_shape")), seed=cfg.get("seed", 42),
        num_shards=num_shards, shard_id=shard_id, num_workers=int(cfg.get("n_workers", 4)),
        placeholder=not reads_rows(cfg.get("mesh_shape")),
    )
    val_ds = _mk_datasets(cfg, "val")
    train_n_clips = int(cfg.get("train_n_clips", 1))
    step_fn, state, num_steps, restorer = common.setup_training(
        cfg, model,
        lambda m, opt: make_qa_train_step(m, opt, n_options=n_options, n_clips=train_n_clips,
                                          num_frm=int(cfg.num_frm)),
        steps_per_epoch=len(train_loader),
    )
    LOGGER.info("training qa for %d steps", num_steps)
    state = common.run_train_loop(
        cfg, step_fn, state, InfiniteIterator(train_loader), num_steps, restorer=restorer,
        validate_fn=lambda s, gs: validate(model, val_ds, tokenizer, cfg, gs),
        save_model_fn=common.default_save_model_fn(cfg, model),
    )
    validate(model, val_ds, tokenizer, cfg, "final")
    return state


def start_inference(cfg: Config) -> dict:
    """Build the QA model, load the inference weights, answer every question
    of the eval split, and write ``output_dir/qa_results.json`` ({metrics,
    results}). Returns the metrics."""
    common.setup_environment(cfg)
    common.merge_stored_args(cfg, keep=("output_dir", "device"))
    tokenizer = build_tokenizer(cfg.tokenizer_dir)
    _effective_n_options(cfg)  # may force num_labels=1 before the model builds
    model = common.build_model_from_cfg(cfg, "qa")
    common.load_inference_params(model, cfg)
    ds = _mk_datasets(cfg, "val")
    results = inference_qa(model, ds, tokenizer, cfg)
    metrics = ds.evaluate_qa(results)
    LOGGER.info("inference qa: %s", json.dumps(metrics))
    if cfg.get("output_dir") and is_primary():
        with open(os.path.join(cfg.output_dir, "qa_results.json"), "w") as f:
            json.dump({"metrics": metrics, "results": results}, f)
    return metrics


def main(argv=None):
    cfg = get_video_qa_args(argv)
    if cfg.get("do_inference"):
        return start_inference(cfg)
    return start_training(cfg)


if __name__ == "__main__":
    main()
