"""Prompter training through the port's CLI against the JAX CLI.

Both packages' ``run_prompter.start_training`` on ``train_cli_fixtures.
prompter_cfg`` (8 fixture clips 48 × 64, ``headtail`` sampling of 2 frames,
resized to 40, randomly cropped to 32, the temporally consistent RandAugment
N 2 M 5 on every clip; toy widths, fp32, dropout and drop-path 0, B = 2, no
loader threads, 4 steps of AdamW at lr 1e-4 from one ALPRO-key ``.pt``).
Held: the logged ``train_*`` rows (VTC loss and both accuracies) within atol
1e-5, and every parameter of the deploy checkpoint at step 4 within atol
1e-5, JAX's through ``checkpoint/from_jax.py``'s names.
"""

import os

import pytest
import torch

import train_cli_fixtures as T


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("prompter"))
    cfg = T.prompter_cfg(root)
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "prompter", root, seed=5)
    return cfg, T.run_both("run_prompter", cfg, root, "prompter")


def test_losses_match_jax(runs):
    rows = T.check_losses(runs[1])
    assert sorted(rows) == ["train_i2t_acc", "train_loss", "train_t2i_acc"]
    assert all(len(v) == 4 for v in rows.values())


def test_parameters_match_jax(runs):
    cfg, dirs = runs
    jax_sd = T.jax_deploy_params(dirs["alpro_tpu"], 4)
    port_sd = T.port_deploy_params(dirs["alpro_tpu_torch"], 4)
    assert set(port_sd) == set(jax_sd)
    T.check_params(jax_sd, port_sd)
    e2e = torch.load(cfg["e2e_weights_path"], weights_only=True)
    moved = max(float((port_sd[k] - e2e[k]).abs().max()) for k in port_sd)
    assert moved > 10 * T.PARAM_ATOL


def test_run_layout(runs):
    """The deploy checkpoints at the validation steps and both resume slots,
    as the JAX run writes them."""
    out = runs[1]["alpro_tpu_torch"]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["model_step_2.pt", "model_step_4.pt"]
    assert sorted(os.listdir(os.path.join(out, "restore"))) == ["a.done", "a.pt", "b.done", "b.pt"]
    assert sorted(os.listdir(os.path.join(runs[1]["alpro_tpu"], "ckpt"))) == [
        "model_step_2", "model_step_4"]


def test_objective_checks():
    """VTC alone, as the JAX CLI asserts."""
    from alpro_tpu_torch.cli import run_prompter
    from alpro_tpu_torch.core.config import Config

    for bad in ({"use_itc": False}, {"use_itm": True}, {"use_mlm": True}):
        with pytest.raises(ValueError, match="use_itc|contrastive-only"):
            run_prompter.start_training(Config(dict(device="cpu", **bad)))
