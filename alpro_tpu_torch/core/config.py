"""Config system with the reference's JSON-overlay-over-argparse semantics.

The port's own copy of ``alpro_tpu/core/config.py``: a JSON config file fills
any flag that was not explicitly passed on the command line, CLI flags always
win, and int flags declared as booleans (0/1) are coerced to bool.

The parsers declare every flag of the JAX package's three parsers, with
its names, types and defaults, so that a command line the JAX CLIs take
runs on the port. Flags that the JAX CLIs declare and never read
(``--inference_split``, ``--img_input_format``, ``--num_workers``,
``--eval_retrieval_batch_size``, ``--classifier``, ``--dropout``,
``--pin_mem``) have no effect here either. ``--scan_blocks`` and
``--xla_compiler_options`` steer XLA's compile alone (scanned blocks give
the unrolled math): the port accepts them and logs once that they have no
effect on it (``cli/common.py::setup_environment``). ``--mesh_shape`` takes
``N`` (dp) and ``DP SP`` (SP > 1: the model's sequence-parallel layout).
Keys that the JAX CLIs read from a config file with a default
(``apply_weight_decay``, ``prefetch_depth``, ``vtm_negative_blocks``, and
for pretraining ``prompt_chunk_size`` and ``num_val_batches``) are declared
here with that default. ``--device`` (default ``cuda``) takes the place of
the JAX package's ``ALPRO_PLATFORM``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, List, Optional


class Config(dict):
    """A dict with attribute access (stand-in for easydict.EasyDict)."""

    def __getattr__(self, name: str) -> Any:
        try:
            val = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return val

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return Config({k: Config._wrap(v) for k, v in value.items()})
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = Config._wrap(v)


def load_json_config(path: str) -> Config:
    with open(path) as f:
        return Config(json.load(f))


def parse_with_config(
    parser: argparse.ArgumentParser, argv: Optional[List[str]] = None
) -> Config:
    """Parse args; if --config is given, JSON values override argparse defaults
    but explicit CLI flags override the JSON (explicit flags are found by
    scanning argv for ``--key``)."""
    argv = list(sys.argv[1:]) if argv is None else list(argv)
    parsed = parser.parse_args(argv)
    args = Config(vars(parsed))
    if getattr(parsed, "config", None):
        config_args = load_json_config(parsed.config)
        override_keys = {
            arg[2:].split("=")[0] for arg in argv if arg.startswith("--")
        }
        for k, v in config_args.items():
            if k not in override_keys:
                args[k] = Config._wrap(v)
    del args["config"]
    return _coerce_bool_flags(args)


# flags that the reference declares as 0/1 ints but uses as booleans
_BOOL_FLAGS = (
    "do_inference",
    "pin_mem",
    "use_itm",
    "use_mlm",
    "use_itc",
    "use_mpm",
    "fp16",
    "debug",
    "albef_init",
)


def _coerce_bool_flags(args: Config) -> Config:
    for k in _BOOL_FLAGS:
        if k in args and isinstance(args[k], int):
            args[k] = bool(args[k])
    return args


class _MeshShape(argparse.Action):
    """``--mesh_shape N`` (dp) or ``DP SP`` (SP > 1 splits the video tower's
    frames over ``sp`` in training)."""

    def __call__(self, parser, namespace, values, option_string=None):
        if len(values) > 2:
            parser.error(f"{option_string} takes N or DP SP, got {values}")
        setattr(namespace, self.dest, values)


def shared_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The flags of the task CLIs: every flag of the JAX package's
    ``shared_training_args``, with its names and defaults, and the port's
    own (``--device``, the config-file keys of the JAX CLIs)."""
    from alpro_tpu_torch.models.remat import REMAT_POLICIES

    parser.add_argument("--config", type=str, default=None, help="JSON config path")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--debug", type=int, default=0)
    parser.add_argument("--data_ratio", type=float, default=1.0)
    parser.add_argument("--model_config", type=str, default=None)
    parser.add_argument("--visual_model_cfg", type=str, default=None)
    parser.add_argument("--tokenizer_dir", type=str, default=None)
    parser.add_argument("--e2e_weights_path", type=str, default=None)
    parser.add_argument("--visual_weights_path", type=str, default=None)
    parser.add_argument("--max_txt_len", type=int, default=40)
    parser.add_argument("--crop_img_size", type=int, default=224)
    parser.add_argument("--resize_size", type=int, default=256)
    parser.add_argument("--img_pixel_mean", type=float, nargs=3, default=None)
    parser.add_argument("--img_pixel_std", type=float, nargs=3, default=None)
    parser.add_argument("--img_input_format", type=str, default="RGB")  # read by neither CLI
    parser.add_argument("--num_frm", type=int, default=8)
    parser.add_argument("--frm_sampling_strategy", type=str, default="uniform")
    parser.add_argument("--train_n_clips", type=int, default=1)
    parser.add_argument("--train_batch_size", type=int, default=8)
    parser.add_argument("--val_batch_size", type=int, default=8)
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--learning_rate", type=float, default=5e-5)
    parser.add_argument("--log_interval", type=int, default=100)
    parser.add_argument("--num_valid", type=int, default=20)
    parser.add_argument("--min_valid_steps", type=int, default=100)
    parser.add_argument("--save_steps_ratio", type=float, default=0.01)
    parser.add_argument("--num_train_epochs", type=int, default=10)
    parser.add_argument("--optim", type=str, default="adamw", choices=["adamw"])
    parser.add_argument("--betas", type=float, nargs=2, default=[0.9, 0.98])
    parser.add_argument("--decay", type=str, default="linear")
    parser.add_argument("--dropout", type=float, default=0.1)  # read by neither CLI
    parser.add_argument("--weight_decay", type=float, default=1e-3)
    # read by the JAX CLI from a config file only (default off: the
    # reference never forwards its weight decay)
    parser.add_argument("--apply_weight_decay", type=int, default=0)
    parser.add_argument("--grad_norm", type=float, default=2.0)
    parser.add_argument("--warmup_ratio", type=float, default=0.1)
    parser.add_argument("--transformer_lr_mul", type=float, default=1.0)
    parser.add_argument("--step_decay_epochs", type=int, nargs="+", default=None)
    parser.add_argument("--adam_mu_dtype", type=str, default=None,
                        choices=["bfloat16", "float32"],
                        help="AdamW first-moment storage dtype (default fp32)")
    parser.add_argument("--adam_nu_dtype", type=str, default=None,
                        choices=["bfloat16", "float32"],
                        help="AdamW second-moment storage dtype (default fp32)")
    parser.add_argument("--fp16", type=int, default=0)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--num_workers", type=int, default=4)  # read by neither CLI
    parser.add_argument("--n_workers", type=int, default=4)
    # XLA's compile alone (no effect on the port: cli/common.py logs it)
    parser.add_argument("--scan_blocks", type=int, default=1)
    parser.add_argument("--pin_mem", type=int, default=1)  # read by neither CLI
    parser.add_argument("--do_inference", type=int, default=0)
    parser.add_argument("--inference_model_step", type=str, default="")
    # direct path to an ALPRO-key .pt checkpoint to run inference with
    parser.add_argument("--inference_model_ckpt", type=str, default=None)
    parser.add_argument("--inference_split", type=str, default="val")  # read by neither CLI
    parser.add_argument("--inference_txt_db", type=str, default=None)
    parser.add_argument("--inference_img_db", type=str, default=None)
    parser.add_argument("--inference_batch_size", type=int, default=64)
    parser.add_argument("--inference_n_clips", type=int, default=1)
    parser.add_argument("--mesh_shape", type=int, nargs="+", default=None, action=_MeshShape,
                        help="process mesh, one process per GPU: --mesh_shape N for dp=N; "
                        "DP SP for a 2D dp x sp mesh (sp splits the temporal attention's "
                        "frames in training)")
    parser.add_argument("--attn_impl", type=str, default="auto",
                        choices=["auto", "xla", "pallas"])
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--profile", type=int, default=0,
                        help="trace train steps [start+2, start+7) with torch.profiler")
    # XLA's compile alone (no effect on the port: cli/common.py logs it)
    parser.add_argument("--xla_compiler_options", type=str, default="")
    parser.add_argument("--remat_policy", type=str, default="dots_ln",
                        choices=list(REMAT_POLICIES),
                        help="what per-block gradient checkpointing keeps "
                             "(models/remat.py): 'dots_ln' the matrix products' "
                             "outputs and the LayerNorms' statistics, 'nothing' a "
                             "full recompute, the other JAX policies as there")
    # read by the JAX CLI from a config file only, with these defaults
    parser.add_argument("--prefetch_depth", type=int, default=2,
                        help="batches staged on the device ahead of the step "
                             "(0: staged in the loop)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the model runs on; 'cpu' only when "
                             "asked for (with no GPU the default raises)")
    parser.add_argument("--train_datasets", type=json.loads, default=None)
    parser.add_argument("--val_datasets", type=json.loads, default=None)
    return parser


def get_video_retrieval_args(argv=None) -> Config:
    parser = argparse.ArgumentParser("video retrieval")
    shared_args(parser)
    # read by the JAX CLI from a config file only, with this default
    parser.add_argument("--vtm_negative_blocks", type=int, default=1)
    parser.add_argument("--eval_retrieval_batch_size", type=int, default=256)  # read by neither
    parser.add_argument(
        "--eval_rerank_topk", type=int, default=0,
        help="0 (default): the exact reference protocol — VTM-score every "
             "(video, text) pair. K>0: VTM-rerank only each text's K best "
             "VTC candidates (non-candidates rank below by VTC sim); exact "
             "whenever the protocol's own top ranks fall inside the VTC "
             "top-K. With 0<K<V the video2text direction is an "
             "approximation (only texts that shortlisted the video get VTM "
             "ranks)")
    return parse_with_config(parser, argv)


def get_video_qa_args(argv=None) -> Config:
    parser = argparse.ArgumentParser("video qa")
    shared_args(parser)
    parser.add_argument("--task", type=str, default="msrvtt_qa")
    # multi-choice (action/transition) option count
    parser.add_argument("--n_options", type=int, default=5)
    parser.add_argument("--ans2label_path", type=str, default=None)
    parser.add_argument("--num_labels", type=int, default=1500)
    parser.add_argument("--classifier", type=str, default="mlp")  # read by neither CLI
    parser.add_argument("--cls_hidden_scale", type=int, default=2)
    parser.add_argument("--score_agg_func", type=str, default="mean",
                        choices=["mean", "max", "lse"])
    return parse_with_config(parser, argv)


def get_pretraining_args(argv=None) -> Config:
    """The pretraining and prompter CLIs' flags: the shared ones, the
    objectives (``use_itc``, ``use_itm``, ``use_mlm``, ``use_mpm``), the
    teacher, the entity list and ``albef_init``, with the JAX parser's
    defaults."""
    parser = argparse.ArgumentParser("pretrain")
    shared_args(parser)
    parser.add_argument("--use_itm", type=int, default=1)
    parser.add_argument("--use_mlm", type=int, default=1)
    parser.add_argument("--use_itc", type=int, default=1)
    parser.add_argument("--use_mpm", type=int, default=1)
    parser.add_argument("--model_type", type=str, default="pretrain")
    parser.add_argument("--teacher_weights_path", type=str, default=None)
    parser.add_argument("--entity_file_path", type=str, default=None)
    parser.add_argument("--num_entities", type=int, default=1000)
    parser.add_argument("--fps", type=float, default=0.5)
    parser.add_argument("--albef_init", type=int, default=0)
    # read by the JAX CLIs from a config file only, with these defaults
    parser.add_argument("--vtm_negative_blocks", type=int, default=1)
    parser.add_argument("--prompt_chunk_size", type=int, default=512,
                        help="prompts per teacher text call when building the prompt banks")
    parser.add_argument("--num_val_batches", type=int, default=2,
                        help="batches of each val dataset per validation")
    return parse_with_config(parser, argv)
