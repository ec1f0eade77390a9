"""Shared set-up of the training-CLI parity tests (``tests/test_torch_cli_train*.py``):
toy model configs, the fixture data of ``tests/fixtures.py``, one ALPRO-key
``.pt`` as both CLIs' ``e2e_weights_path``, runs of
both packages' ``start_training``, and readers of what a run wrote."""

import json
import os

import numpy as np
import torch

from alpro_tpu.core.config import Config as JaxConfig
from alpro_tpu.data.tokenization import make_test_vocab
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.core.config import Config

BASE = {"attention_probs_dropout_prob": 0.0, "hidden_dropout_prob": 0.0, "hidden_size": 32,
        "intermediate_size": 64, "num_attention_heads": 4, "num_hidden_layers": 4,
        "vocab_size": 200, "max_position_embeddings": 64, "fusion_layer": 2, "pad_token_id": 0}
VIS = {"patch_size": 16, "embed_dim": 32, "depth": 2, "num_heads": 4, "drop_rate": 0,
       "attn_drop_rate": 0, "drop_path_rate": 0.0}
LOSS_ATOL = PARAM_ATOL = 1e-5


def toy_cfg(root, **kw):
    """The shared training config: toy widths, fp32, dropout and drop-path
    0, B = 2 (the hard-negative sampler has one choice), no loader threads,
    AdamW at lr 1e-4, metrics every step, validation twice."""
    paths = [os.path.join(root, n) for n in ("base_model.json", "vis_model.json", "vocab.txt")]
    for path, body in zip(paths[:2], (BASE, VIS)):
        with open(path, "w") as f:
            json.dump(body, f)
    with open(paths[2], "w") as f:
        f.writelines(tok + "\n" for tok in make_test_vocab())
    cfg = dict(model_config=paths[0], visual_model_cfg=paths[1], tokenizer_dir=paths[2],
               max_txt_len=12, crop_img_size=32, resize_size=40, num_frm=2, train_batch_size=2,
               val_batch_size=4, inference_batch_size=4, eval_video_batch_size=3,
               num_train_epochs=1, learning_rate=1e-4, betas=[0.9, 0.98], decay="linear",
               warmup_ratio=0.1, weight_decay=0.0, grad_norm=5.0, seed=42,
               compute_dtype="float32", attn_impl="auto", n_workers=0, log_interval=1,
               num_valid=2, min_valid_steps=1, save_steps_ratio=0.5,
               frm_sampling_strategy="rand", gradient_accumulation_steps=1, debug=False,
               do_inference=False, mesh_shape=None, inference_txt_db=None,
               inference_img_db=None)
    cfg.update(kw)
    return cfg


def export_e2e(cfg, task, root, seed):
    """The port's seeded init of ``task``'s model at ``cfg`` → an ALPRO-key
    ``.pt`` (every parameter), which both CLIs load as ``e2e_weights_path``."""
    from alpro_tpu_torch.checkpoint.load import alpro_state_dict_of
    from alpro_tpu_torch.cli import common

    model = common.build_model_from_cfg(Config(dict(cfg, device="cpu")), task, seed=seed)
    path = os.path.join(root, f"{task}_e2e.pt")
    torch.save(alpro_state_dict_of(model), path)
    return path


def run_both(module, cfg, root, name, states=None):
    """Both packages' ``start_training`` of CLI ``module`` on ``cfg``, each
    in its own output directory → {package: output_dir}; the train states
    they return go into ``states`` when given."""
    import importlib

    dirs = {}
    for pkg, config, extra in (("alpro_tpu", JaxConfig, {}),
                               ("alpro_tpu_torch", Config, {"device": "cpu"})):
        out = os.path.join(root, name, pkg)
        state = importlib.import_module(f"{pkg}.cli.{module}").start_training(
            config(dict(cfg, output_dir=out, **extra)))
        dirs[pkg] = out
        if states is not None:
            states[pkg] = state
    return dirs


def metric_rows(out_dir, prefix):
    """The (key, value) rows of ``out_dir/log/metrics.jsonl`` whose key
    starts with ``prefix``, in order."""
    with open(os.path.join(out_dir, "log", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["key"], r["value"]) for r in rows if r["key"].startswith(prefix)]


def by_key(rows):
    """{key: [values in order]} (JAX writes a step's keys sorted, the port
    in its metrics' order)."""
    out = {}
    for k, v in rows:
        out.setdefault(k, []).append(v)
    return out


def check_losses(dirs):
    """The ``train_*`` series of both runs, key by key, within LOSS_ATOL. The
    port's pretraining also logs ``train_mpm_kept`` (the EWMA of the rows MPM
    kept, which the JAX CLI does not report): a series as long as the loss's,
    between 0 and the global batch."""
    jax_rows = by_key(metric_rows(dirs["alpro_tpu"], "train_"))
    port_rows = by_key(metric_rows(dirs["alpro_tpu_torch"], "train_"))
    if "train_mpm_loss" in jax_rows:
        kept = port_rows.pop("train_mpm_kept")
        with open(os.path.join(dirs["alpro_tpu_torch"], "log", "args.json")) as f:
            batch = json.load(f)["train_batch_size"]
        assert len(kept) == len(jax_rows["train_loss"])
        assert all(0 <= v <= batch for v in kept)
    assert port_rows.keys() == jax_rows.keys() and jax_rows
    for k, want in jax_rows.items():
        np.testing.assert_allclose(port_rows[k], want, atol=LOSS_ATOL, rtol=0, err_msg=k)
    return jax_rows


def jax_deploy_params(out_dir, step):
    """The JAX run's deploy checkpoint ``ckpt/model_step_{step}`` (orbax, the
    unrolled layout) in ALPRO keys."""
    from alpro_tpu.checkpoint.orbax_io import load_params

    return alpro_state_dict(load_params(os.path.join(out_dir, "ckpt", f"model_step_{step}")))


def port_deploy_params(out_dir, step):
    return torch.load(os.path.join(out_dir, "ckpt", f"model_step_{step}.pt"), weights_only=True)


def check_params(jax_sd, port_sd, skip=()):
    """Every parameter of the port's checkpoint within PARAM_ATOL of JAX's."""
    keys = [k for k in port_sd if not any(k.startswith(s) for s in skip)]
    assert keys and set(keys) <= set(jax_sd)
    for k in keys:
        np.testing.assert_allclose(port_sd[k].float().numpy(), np.asarray(jax_sd[k]),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


def check_run(dirs, last_step, n_val_rows, skip=()):
    """Losses within atol, the validation rows equal (at least
    ``n_val_rows``), and every parameter of the deploy checkpoint at
    ``last_step`` (but ``skip``) within atol."""
    check_losses(dirs)
    jax_val = by_key(metric_rows(dirs["alpro_tpu"], "val_"))
    assert sum(map(len, jax_val.values())) >= n_val_rows
    assert by_key(metric_rows(dirs["alpro_tpu_torch"], "val_")) == jax_val
    jax_sd = jax_deploy_params(dirs["alpro_tpu"], last_step)
    port_sd = port_deploy_params(dirs["alpro_tpu_torch"], last_step)
    assert set(port_sd) == set(jax_sd)
    check_params(jax_sd, port_sd, skip)


ENTITIES = ["dog", "cat", "ball", "person"]


def pretrain_cfg(root, **kw):
    """The pretraining CLIs' shared config over ``toy_cfg``: 8 fixture clips
    (48 × 64, 4 frames, ``headtail`` sampling of 2) and 8 ``.npy`` images
    (48²), both cropped to 32; an entity file of ``ENTITIES``; the banks in
    chunks of 8 prompts; ``max_txt_len`` 10. The train and val sets are the
    video set, and with ``mixed`` (the default) also the image set."""
    from fixtures import write_image_dataset, write_video_dataset

    v_ann, v_dir, _ = write_video_dataset(root, n_videos=8, t=4, h=48, w=64)
    i_ann, i_dir, _ = write_image_dataset(root, n=8, h=48, w=48)
    ents = os.path.join(root, "unigrams.txt")
    with open(ents, "w") as f:
        f.writelines(e + "\n" for e in ENTITIES)
    video = {"name": "webvid", "ann": v_ann, "img": v_dir, "type": "video"}
    image = {"name": "cc3m", "ann": i_ann, "img": i_dir, "type": "image"}
    mixed = kw.pop("mixed", True)
    cfg = toy_cfg(root, train_datasets=[video, image] if mixed else [video],
                  val_datasets=[video], frm_sampling_strategy="headtail", max_txt_len=10,
                  entity_file_path=ents, num_entities=len(ENTITIES), prompt_chunk_size=8,
                  use_itc=True, use_itm=True, use_mlm=True, use_mpm=True, num_val_batches=2,
                  vtm_negative_blocks=1, albef_init=False, fps=0.5, model_type="pretrain")
    cfg.update(kw)
    return cfg


def prompter_cfg(root, **kw):
    """``pretrain_cfg`` for the prompter: VTC alone, the video set alone."""
    return pretrain_cfg(root, mixed=False, use_itm=False, use_mlm=False, use_mpm=False,
                        model_type="prompter", **kw)


def record_pretrain_validation(monkeypatch):
    """Wrap both pretraining CLIs' eval function so that the metrics of each
    eval batch are recorded (JAX's through ``jax.debug.callback``, its
    function being jitted) → {package: [metrics dict per eval batch]}."""
    import jax

    from alpro_tpu.train import step as jax_step
    from alpro_tpu_torch.cli import run_pretrain

    seen = {"alpro_tpu": [], "alpro_tpu_torch": []}

    def jax_make(*args, _make=jax_step.make_pretrain_eval_fn, **kwargs):
        fn = _make(*args, **kwargs)

        def recording(*a, **k):
            out = fn(*a, **k)
            jax.debug.callback(lambda m: seen["alpro_tpu"].append(
                {key: float(v) for key, v in m.items()}), out)
            return out
        return recording

    def port_make(*args, _make=run_pretrain.make_pretrain_eval_fn, **kwargs):
        fn = _make(*args, **kwargs)

        def recording(*a, **k):
            out = fn(*a, **k)
            seen["alpro_tpu_torch"].append({key: float(v) for key, v in out.items()})
            return out
        return recording

    monkeypatch.setattr(jax_step, "make_pretrain_eval_fn", jax_make)
    monkeypatch.setattr(run_pretrain, "make_pretrain_eval_fn", port_make)
    return seen
