"""Retrieval finetuning through the port's CLI against the JAX CLI.

Both packages' ``start_training`` (``--do_inference 0``) on the fixtures of
``tests/fixtures.py`` (8 clips 48 × 64, 4 frames, ``rand`` sampling of 2,
resized to 40 and randomly cropped to 32) at toy widths (BERT hidden 32, 4
layers, fusion_layer 2; TimeSformer D 32, depth 2), fp32, dropout and
drop-path 0, B = 2 (the hard-negative sampler has one choice), no loader
threads, 4 steps of AdamW at lr 1e-4 from one ALPRO-key ``.pt``
(``e2e_weights_path``), validating at steps 2 and 4 and at the end. The
JAX CLI runs on its CPU mesh, its kernels on their XLA lowerings; the port
on the CPU (``device='cpu'``). Held: the logged losses (``metrics.jsonl``'s
``train_*`` rows, EWMA-smoothed alike) within atol 1e-5; every parameter of
the last deploy checkpoint within atol 1e-5 (a tenth of one step's largest
update, lr 1e-4), JAX's through ``checkpoint/from_jax.py``'s names;
``validate``'s R@k rows equal; and ``--inference_model_step 4`` reading the
port's ``ckpt/model_step_4.pt`` back bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import train_cli_fixtures as T
from alpro_tpu_torch.core.config import Config
from fixtures import write_video_dataset


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ret_train"))
    ann, vid_dir, _ = write_video_dataset(root, n_videos=8, t=4, h=48, w=64)
    cfg = T.toy_cfg(root, train_datasets=[{"txt": ann, "img": vid_dir}],
                    val_datasets=[{"txt": ann, "img": vid_dir}])
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "retrieval", root, seed=3)
    return cfg, T.run_both("run_video_retrieval", cfg, root, "ret")


def test_losses_match_jax(runs):
    _, dirs = runs
    rows = T.check_losses(dirs)
    assert sorted(rows) == ["train_loss", "train_vtc_loss", "train_vtm_loss"]
    assert all(len(v) == 4 for v in rows.values())  # at each of the 4 steps


def test_parameters_match_jax(runs):
    _, dirs = runs
    jax_sd = T.jax_deploy_params(dirs["alpro_tpu"], 4)
    port_sd = T.port_deploy_params(dirs["alpro_tpu_torch"], 4)
    assert set(port_sd) == set(jax_sd)
    T.check_params(jax_sd, port_sd)
    e2e = torch.load(runs[0]["e2e_weights_path"], weights_only=True)
    moved = max(float((port_sd[k] - e2e[k]).abs().max()) for k in port_sd)
    assert moved > 10 * T.PARAM_ATOL  # the steps moved the weights past the tolerance


def test_validation_recall_matches_jax(runs):
    _, dirs = runs
    jax_rows = T.by_key(T.metric_rows(dirs["alpro_tpu"], "val_"))
    assert len(jax_rows["val_t2v_r1"]) == 3  # steps 2 and 4, and the final validate
    assert T.by_key(T.metric_rows(dirs["alpro_tpu_torch"], "val_")) == jax_rows


def test_run_layout_and_inference_model_step(runs):
    """The port's run holds JAX's files (its deploy checkpoints at the
    validation steps, both resume slots, ``log/args.json``);
    ``--inference_model_step 4`` reads ``model_step_4.pt`` back bit for bit,
    and a step with no checkpoint raises naming its path."""
    from alpro_tpu_torch.cli import common

    cfg, dirs = runs
    out = dirs["alpro_tpu_torch"]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["model_step_2.pt", "model_step_4.pt"]
    assert sorted(os.listdir(os.path.join(out, "restore"))) == ["a.done", "a.pt", "b.done", "b.pt"]
    assert os.path.exists(os.path.join(out, "log", "args.json"))
    icfg = Config(dict(cfg, device="cpu", output_dir=out, do_inference=True,
                       inference_model_step="4"))
    model = common.load_inference_params(common.build_model_from_cfg(icfg, "retrieval"), icfg)
    saved = T.port_deploy_params(out, 4)
    from alpro_tpu_torch.checkpoint.load import alpro_state_dict_of

    got = alpro_state_dict_of(model)
    assert set(got) == set(saved)
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(FileNotFoundError, match="model_step_3.pt"):
        common.load_inference_params(model, Config(dict(icfg, inference_model_step="3")))
