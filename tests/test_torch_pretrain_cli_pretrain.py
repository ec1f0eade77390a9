"""ALPRO pretraining through the port's CLI against the JAX CLI.

Both packages' ``run_pretrain.start_training`` on ``train_cli_fixtures.
pretrain_cfg``: the video set (8 fixture clips, RandAugment N 2 M 5) and the
image set (8 ``.npy`` images through the bicubic ``random_resized_crop``, the
flip and RandAugment N 2 M 7) mixed by ``MetaLoader``; all four objectives;
the frozen teacher read from an ALPRO-key prompter ``.pt``, its video and
image banks over 4 entities in chunks of 8 prompts; the student from one
ALPRO-key ``.pt`` with both heads. Toy widths, fp32, dropout and drop-path
0, B = 2 (the hard-negative sampler has one choice), no loader threads, 8
steps of AdamW at lr 1e-4, ``validate`` at steps 4 and 8 over 2 batches of
the video set. Held: the logged ``train_*`` rows within atol 1e-5, every
parameter of the step-8 deploy checkpoint (the heads' too) within atol 1e-5,
and each eval batch's ``val_*`` metrics within atol 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import train_cli_fixtures as T


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pretrain"))
    cfg = T.pretrain_cfg(root)
    cfg["teacher_weights_path"] = T.export_e2e(cfg, "prompter", root, seed=7)
    cfg["e2e_weights_path"] = T.export_e2e(cfg, "pretrain", root, seed=3)
    mp = pytest.MonkeyPatch()
    try:
        seen = T.record_pretrain_validation(mp)
        dirs = T.run_both("run_pretrain", cfg, root, "pretrain")
    finally:
        mp.undo()
    return cfg, dirs, seen


def test_losses_match_jax(runs):
    rows = T.check_losses(runs[1])
    assert sorted(rows) == ["train_itc_loss", "train_itm_loss", "train_loss", "train_mlm_loss",
                            "train_mpm_loss"]
    assert all(len(v) == 8 for v in rows.values())
    assert max(rows["train_mlm_loss"]) > 0 and min(rows["train_mpm_loss"]) > 0


def test_parameters_match_jax(runs):
    cfg, dirs, _ = runs
    jax_sd = T.jax_deploy_params(dirs["alpro_tpu"], 8)
    port_sd = T.port_deploy_params(dirs["alpro_tpu_torch"], 8)
    assert set(port_sd) == set(jax_sd)
    assert {"text_encoder.cls.predictions.bias", "mpm_head.2.weight"} <= set(port_sd)
    torch.testing.assert_close(port_sd["text_encoder.cls.predictions.bias"],
                               port_sd["text_encoder.cls.predictions.decoder.bias"],
                               rtol=0, atol=0)
    T.check_params(jax_sd, port_sd)
    e2e = torch.load(cfg["e2e_weights_path"], weights_only=True)
    for head in ("text_encoder.cls.predictions.decoder.weight", "mpm_head.2.weight"):
        assert float((port_sd[head] - e2e[head]).abs().max()) > 10 * T.PARAM_ATOL, head


def test_validation_matches_jax(runs):
    seen = runs[2]
    jax_rows, port_rows = seen["alpro_tpu"], seen["alpro_tpu_torch"]
    assert len(jax_rows) == len(port_rows) == 4  # 2 batches at steps 4 and 8
    for j, p in zip(jax_rows, port_rows):
        assert sorted(p) == sorted(j) == [
            "val_itc_loss", "val_itm_loss", "val_mlm_acc", "val_mlm_loss", "val_mpm_loss",
            "val_t2v_acc", "val_v2t_acc"]
        for k in j:
            np.testing.assert_allclose(p[k], j[k], atol=1e-5, rtol=0, err_msg=k)


def test_run_layout(runs):
    out = runs[1]["alpro_tpu_torch"]
    assert sorted(os.listdir(os.path.join(out, "ckpt"))) == ["model_step_4.pt", "model_step_8.pt"]
    assert sorted(os.listdir(os.path.join(out, "restore"))) == ["a.done", "a.pt", "b.done", "b.pt"]
    restored = torch.load(os.path.join(out, "restore", "a.pt"), weights_only=True)
    teacher = torch.load(runs[0]["teacher_weights_path"], weights_only=True)
    # the teacher is not in the train state: the slot holds the student alone
    assert set(restored["params"]) == set(T.port_deploy_params(out, 8))
    assert not any(k.startswith("prompter.") for k in restored["params"])
    assert len(teacher) < len(restored["params"])
