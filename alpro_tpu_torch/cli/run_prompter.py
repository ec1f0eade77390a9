"""Prompter (the pretraining teacher) training: VTC alone.

The port's counterpart of ``alpro_tpu/cli/run_prompter.py``:

    python -m alpro_tpu_torch.cli.run_prompter --config configs/pretrain_prompter.json \
        --output_dir out/ [--device cpu]

Trains the bare ALPRO model by VTC on the first training dataset's (clip,
caption) pairs (the video pretraining dataset, its RandAugment included),
through ``cli/common.py``'s setup and loop, and writes deploy checkpoints
``ckpt/model_step_N.pt`` (the teacher ``run_pretrain`` reads as
``teacher_weights_path``) and resume checkpoints in ``restore/``.
"""

from __future__ import annotations

from alpro_tpu_torch.cli import common
from alpro_tpu_torch.core.config import Config, get_pretraining_args
from alpro_tpu_torch.core.logging import LOGGER
from alpro_tpu_torch.data.datasets import PretrainCollator, PretrainVideoDataset, load_datalist
from alpro_tpu_torch.data.loader import BatchLoader, InfiniteIterator
from alpro_tpu_torch.data.tokenization import build_tokenizer
from alpro_tpu_torch.train.step import make_prompter_train_step


def start_training(cfg: Config):
    """Train the prompter; returns the train state. VTC only: ``use_itc``
    must be on and ``use_itm``/``use_mlm`` off, as the JAX CLI asserts."""
    if not bool(cfg.get("use_itc", True)):
        raise ValueError("prompter training requires use_itc")
    if bool(cfg.get("use_itm", 0)) or bool(cfg.get("use_mlm", 0)):
        raise ValueError("prompter training is contrastive-only (use_itm 0, use_mlm 0)")
    common.setup_environment(cfg)
    tokenizer = build_tokenizer(cfg.tokenizer_dir)
    model = common.build_model_from_cfg(cfg, "prompter", seed=cfg.get("seed", 42))

    spec = cfg.train_datasets[0]
    rows = load_datalist(spec.get("ann") or spec["txt"])
    if cfg.get("data_ratio", 1.0) < 1.0:
        rows = rows[: max(1, int(len(rows) * cfg.data_ratio))]
    ds = PretrainVideoDataset(
        rows, spec["img"], num_frm=cfg.num_frm,
        frm_sampling_strategy=cfg.get("frm_sampling_strategy", "headtail"),
        resize_size=cfg.resize_size, crop_size=cfg.crop_img_size, seed=cfg.get("seed", 42),
    )
    collator = PretrainCollator(tokenizer, cfg.get("max_txt_len", 30), mlm=False, mpm=False)
    loader = BatchLoader(ds, collator, cfg.train_batch_size, seed=cfg.get("seed", 42),
                         num_workers=int(cfg.get("n_workers", 4)))
    step_fn, state, num_steps, restorer = common.setup_training(
        cfg, model, make_prompter_train_step, steps_per_epoch=len(loader))
    LOGGER.info("training prompter (VTC only) for %d steps on %s", num_steps,
                common.model_device(model))
    return common.run_train_loop(
        cfg, step_fn, state, InfiniteIterator(loader), num_steps, restorer=restorer,
        save_model_fn=common.default_save_model_fn(cfg, model),
    )


def main(argv=None):
    return start_training(get_pretraining_args(argv))


if __name__ == "__main__":
    main()
